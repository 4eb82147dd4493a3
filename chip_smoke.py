#!/usr/bin/env python3
"""Drive the PyTorch port of SemiSFL on one NVIDIA GPU and check it.

  python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

  1. the card's name and power limit, the torch and CUDA versions; TF32
     off for matmuls and convolutions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card
     (clustering loss and dz at the shapes of the JAX kernel tests, at the
     split-and-merge edges (an empty Q-block with positives only in the
     ragged last one, valid entries only there, none at all), at d 1, on
     queue rows off 16 bytes, an empty queue and the training round's
     shape, where two launches must agree bit for bit, with the ptxas
     report, grid and residency of the partial kernels; int8/fp8
     quantization bit for bit, every case through both of the quantizer's
     routes where a cluster holds the slice (the fused one-pass kernel
     and the two passes) and the wrapper's own pick, each route's amax
     and two launches of it too: the round's batch with a zero slice, a
     tiny slice and x == amax, the same off 16 bytes, (1000,), (3, 333),
     all zeros, the fused route's largest slice and one float more, the
     paper-vgg13 and paper-vgg16 cuts, fp8 at +-448; flash attention, fp32
     through the
     CUDA-core kernel and bf16 through the wgmma one, at the JAX kernel
     tests' shapes, windows and
     non-causal case, at ragged lengths, with 5 query heads per KV head,
     then in bf16 off the 128-row tiles, with a window across tile edges,
     groups of 5 and 8, a peaked softmax and every head dim, MLA's pair of
     q/k head dim 192 over v head dim 128 in both types (ragged Sq,
     non-causal Skv != Sq, rows that see no key, a window, GQA, a peaked
     softmax, the MLA prefill's views), and at Qwen3-14B's, Zamba2-7B's
     and DeepSeek-V2's prefill shapes (the last (4, 128, 2048, 192) over
     v (4, 128, 2048, 128), beside the backend PyTorch's
     ``scaled_dot_product_attention`` picks for it); (3b) flash attention's
     backward, with the forward's log-sum-exp, fp32 through the CUDA-core
     kernels and bf16 through the wgmma ones (their ptxas report), at small
     shapes (GQA groups 1 to 5, ragged tiles, windows, non-causal, every
     head dim, rows that see no key) and at H2O-Danube-1.8B's training
     shape (windows 0 and 1024, head dims 64, 80 and 128; two launches bit
     for bit), timed there against its plain version, the library's
     backward and the bound; the sLSTM scan, h and
     final state, at
     the JAX kernel tests' shapes, at S = 1, from a non-fresh state, at the
     xLSTM smoke shape and at xLSTM-1.3B's prefill shape; (3c) its backward
     kernel (its ptxas report), with the training forward's saved
     pre-activations and (c, n, m), against the plain backward (dwx, dh_0,
     dR) and the differentiable scan against autograd of the plain scan,
     at those shapes, the plan's edges and xLSTM-1.3B's training shapes (B
     1 and 4, S 4096; two launches bit for bit), an hd the plan refuses
     raising before any launch, timed at B 4 and 1; the Mamba2 scan,
     y and final state, fp32 through the CUDA-core kernel and bf16 through
     the mma one, at the JAX kernel tests' shapes, at S = 1 and ragged S,
     on bf16 strided slices of a conv output, where a chunk's decay passes
     exp's fp32 range, and at Zamba2-7B's prefill shape, with the mma
     kernel's ptxas report, residency and per-phase clocks); (3d) the
     Mamba2 scan's training pair: the forward's training variant (y and
     the final state the serving variant's bit for bit, the chunk states
     against the plain recurrence) and the backward (its ptxas report, the
     mma route's residency) against the plain backward (dx, ddt, dA, dB,
     dC, dD) through each route the plan gives (bf16 on the mma route and
     the first design, fp32 on the first design) at small shapes, a decay
     past exp's range and Zamba2-7B's training shapes (B 1 and 4, S 4096,
     bf16 and fp32; two launches of each route bit for bit), the
     differentiable scan against autograd of the plain scan, both designs'
     per-phase clocks and both routes timed in turns at B 4 and 1; also in
     3b the flash forward and backward at Zamba2-7B's
     shared-block training shape (hd 112), timed, and the backward at MLA's
     (192, 128) pair (FLASH_BWD_MLA_CASES in both dtypes, rows that see no
     key, DeepSeek-V2's training shape (B, 128, 4096, 192 / 128) at B 4 in
     bf16 and B 1 in both dtypes, two bf16 launches bit for bit; the dK/dV
     kernel's two passes' ptxas report), timed at B 4 and 1; and time
     kernel, plain version and, where one exists, the one PyTorch call
     that computes the same function (the quantizer's versions on inputs
     read from HBM, as its bound assumes, the fused kernel also warm in L2;
     the two-pass kernels at the round's and both VGG cuts);
  4. the first path: ``repro_torch.launch.train.run_training("paper-cnn",
     smoke=False, device="cuda")`` at the full config, through the default
     (scanned) executor, each phase one CUDA graph of its step replayed K
     times (``core/scan.py``), 150 rounds with the ``int8+topk0.05`` wire,
     long enough for the teacher to become confident on part of the
     batch, and 1 with ``fp32``, with every kernel's launch count read
     just after (the quantizer's fused kernel only); then 3 ``int8``
     rounds of the full paper-vgg13, whose cut takes the quantizer's
     two-pass route, with the counts read again;
  5. one cross-entity step on the card against the same step through the
     port on the CPU, from the same state and draws;
  6. where a warm round's time goes (through the graphs), going on from
     the trained state:
     host wall clock, device busy share and kernel time by name
     (``torch.profiler``), each of the four clustering kernels and the
     fused quantize kernel seen, the quantizer's device time a round;
 6a. the paper's baselines through ``run_training(..., baseline=B)`` at
     paper-cnn's full config with phase 4's clients and batches, 5 rounds
     each from phase 4's trained model (from random weights no
     pseudo-label clears tau within 5 rounds): Supervised-only, SemiFL,
     FedSwitch and FedMatch with no wire (no ported kernel may launch),
     FedSwitch-SL with ``int8+topk0.05`` (the fused quantizer and no
     clustering kernel), every metric finite, each method's local loss
     live in its first round, each run's wall time and the cost model's
     bill a round;
 6b. card against CPU, from each run's state and the same draws: a
     supervised step and a local step of each full-model baseline (beside
     it, how far 1 ulp in the student moves the CPU's result; FedMatch's
     local step also from its run's first state, since its final state
     may have drifted to where no local loss is live), and a
     FedSwitch-SL semi step (its projection head unchanged), to 1e-3;
     then, read and not held, SemiFL's local step with the student scaled
     x40 with its labeller, where a rounding decides a ReLU or max-pool
     choice (card, card with cuDNN off, CPU, the CPU's shift under 1 ulp);
 6c. 3 ``int8`` SemiSFL rounds of the full paper-alexnet (the quantizer's
     fused route) and of the full paper-vgg16 (144 x 144 images, the
     two-pass route), each with its launch counts, peak device memory and
     one profiled round on cuDNN's default algorithms, and its peak
     through the eager executor (over one round) beside it; then the 3
     rounds again
     through the eager executor on its deterministic ones, and from that
     state a card-against-CPU
     semi step at full widths with 2 clients of 8 samples;
 6d. each of the six methods once through the launcher's CLI (``--baseline
     B --full-config --rounds 2 --ckpt``), its checkpoint restored into a
     fresh system bit for bit, with the same test accuracy;
 6e. the round executors, from phase 4's trained state with the same data
     and draws, on cuDNN's deterministic algorithms, at the main path's K_s
     5 / K_u 4 and the published 100 / 10: the graph executor, the eager
     one (``scan_rounds=False``) and the graph one fed by the prefetch
     worker, 1 + 3 + 1 rounds each ("[executors]" lines: the 3 warm
     rounds' walls, the profiled round's device busy time, idle share and
     device ops, launches a round, peak memory, the warm-up and capture's
     host seconds); the graph executors' states and metrics must equal
     the eager one's bit for bit, and their launches a round;
  7. the second path: split-inference serving of the full Qwen3-14B
     (``repro_torch.launch.serve.serve_config``: 40 layers, width 5120,
     bf16, weights drawn on the card from seed 0), batch 4, a 2048-token
     prompt, 32 greedy tokens, with its parameters counted first and the
     launch counts read after the prefill and after the decode (40 flash
     launches in the prefill, all of them the wgmma kernel's, none in
     decode), then the same run again, to PROFILE_TOKENS (8) tokens, under
     ``torch.profiler``;
  8. card against CPU on the serving path: the same fp32 weights of a
     2-layer Qwen3-14B at full width, one prefill of 256 tokens and 4
     decode steps on each;
  9. the third path: split-inference serving of the full xLSTM-1.3B
     (``serve_config``: 48 blocks in 6 groups of 7 mLSTM + 1 sLSTM, width
     2048, bf16 with the fp32 sLSTM weights, weights drawn on the card from
     seed 0), as phase 7;
 10. card against CPU on the xLSTM path: the same fp32 weights of a
     4-block xLSTM-1.3B at full width (sLSTM every 2 blocks, split 1 + 1
     group), one prefill of 256 tokens and 4 decode steps on each;
 11. the fourth path: split-inference serving of the full Zamba2-7B
     (``serve_config``: 81 Mamba2 layers, the weight-shared attention +
     MLP block after every 6, split 18 + 63, width 3584, bf16, weights
     drawn on the card from seed 0), as phase 7, with 81 Mamba2-scan (all
     of them the mma kernel's) and 13 flash-attention launches (all of them
     the wgmma kernel's) required in the prefill and none in decode;
 12. card against CPU on the Zamba2 path: the same fp32 weights of a
     4-layer Zamba2-7B at full width (shared block every 2 layers, split
     2 + 2), one prefill of 256 tokens and 4 decode steps on each;
 12a. the fifth serving path: DeepSeek-V2 at full width, cut to 9 of its
     60 layers for one card (``SERVE_DEPTH``: the dense prefix layer and 8
     layers of MLA + an MoE of 160 routed experts, top 6, and 2 shared,
     split 2 + 7, bf16, weights drawn on the card from seed 0), as phase
     7, with one flash launch a layer in the prefill (the MLA prefill's
     (192, 128) pair, all of them the wgmma kernel's) and none in decode,
     and the tokens each expert took (min and max) in the prefill and in
     decode; then under the profiler;
 12b. card against CPU on it: the same fp32 weights of a 2-layer
     DeepSeek-V2 at full width (the prefix layer and one MLA + MoE layer,
     split 1 + 1), as phase 8, with the smallest gap between the 6th and
     7th routing probability over the positions compared and whether the
     two sides routed every token alike;
 12c. the sixth serving path: the full Qwen2-VL-7B (``serve_config``: 28
     layers split 7 + 21, width 3584, 28 query heads over 4 KV heads of
     128, M-RoPE, bf16, weights drawn on the card from seed 0; 8 patch
     embeddings ahead of the prompt, as the JAX driver draws them), as
     phase 7, one flash launch a layer in the prefill (GQA 7, all the
     wgmma kernel's) and none in decode; then under the profiler;
 12d. card against CPU on it: the same fp32 weights of a 2-layer
     Qwen2-VL-7B at full width (split 1 + 1), as phase 8, the prefill's
     M-RoPE positions with planes that differ (``_grid_serve``);
 12e. the seventh serving path: the full SeamlessM4T-medium (12 encoder
     layers split 6 + 6, 12 decoder layers, width 1024, bf16; 2048 frames
     of ``randn`` frame embeddings and 8 decoder tokens, as the JAX driver
     draws them), as phase 7, with 36 flash launches in the prefill (12
     encoder, non-causal; 12 decoder self- and 12 cross-attention) and 12
     a decode step (the cross-attention over the whole 2080-row cross
     cache, one query row), all the wgmma kernel's; then under the
     profiler;
 12f. card against CPU on it: the same fp32 weights of SeamlessM4T-medium
     at full width cut to 2 encoder layers (split 1 + 1) and 1 decoder
     layer, as phase 8;
 13. the fifth path: LM training of the full H2O-Danube-1.8B
     (``repro_torch.launch.steps.make_scanned_train_phase``: the step one
     CUDA graph replayed a step, the state donated; 24 layers split 6 + 18,
     width 2560, bf16, the ``int8`` wire, tau 0, weights and tokens drawn on
     the card from seed 0), 4 clients x 1 sequence x 4096 tokens, a first
     call of one step (the graph's 2 eager warm-up steps, its capture and
     a replay; its seconds and the capture's printed apart) and 3 timed
     steps in one call, every kernel's launches required in the 2 + 4
     steps (flash forward 126 a step, its backward 42, all through the
     wgmma kernels, the clustering pair 1, the two-pass quantizer 3) and
     in the captured step, peak memory, then one replayed step under the
     profiler (no CUDA-core backward kernel in it);
 14. card against CPU on the LM training path: one step of a 2-layer fp32
     H2O-Danube-1.8B at full width (split 1 + 1), 2 clients x 512 tokens,
     every metric and state leaf to 1e-3, the queue's pseudo-labels equal;
 14a. graph against eager on it (``phase_lm_graph``): a 2-layer bf16
     danube at full width, int8, 4 clients x 4096 tokens, two K=3 calls of
     the eager loop and of the captured, donated phase, every state leaf
     and metric equal bit for bit, launches a step equal, the donated
     phase handing back its static buffers and its second call allocating
     nothing but its metrics; then the prefetched phase (2 phases of K=2
     from host tokens) against the scanned one, bit for bit, no prefetch
     thread left; 16a, 18a and 20a the same on the cut xLSTM, Zamba2 and
     DeepSeek-V2 paths, without the prefetched phase;
 15. the sixth path: LM training of xLSTM-1.3B at full width, as phase 13
     (width 2048, bf16 with the fp32 sLSTM weights), cut to its first 16
     blocks (two groups of 7 mLSTM + 1 sLSTM, split 1 + 1) at rate 2e-4,
     where the full 48 blocks' SemiSFL steps go non-finite at random init
     (LM_TRAIN_PATHS), with the sLSTM scan 15 times a step (teacher,
     student, recompute; 4 client bottoms and the top) and its backward
     kernel 5, the clustering pair and the quantizer as there, no flash;
     each block recomputed in the backward pass;
 16. card against CPU on it: one step of a 4-block fp32 xLSTM-1.3B at full
     width (sLSTM every 2 blocks, split 1 + 1 group), 2 clients x 256
     tokens (two mLSTM chunks), as phase 14;
 17. the seventh path: LM training of Zamba2-7B at full width, as phase 13
     (width 3584, bf16 with the fp32 A_log, D and dt_bias), cut to
     ZAMBA_TRAIN_LAYERS Mamba2 layers for one card's memory (its 3 timed
     steps one K=3 call, the donated state held once), at JAX's rate,
     with the Mamba2 scan 3 times a layer a step (teacher, student,
     recompute; the mma kernel's, writing its chunk states in the
     recompute) and its backward once (all on the mma route, the first
     design's kernels refused in the profiled step), flash attention 3 times per
     application of the shared block (hd 112) and its backward once, the
     clustering pair and the quantizer as there; each Mamba2 layer and
     each application of the shared block recomputed in the backward pass;
 18. card against CPU on it: one step of a 4-layer fp32 Zamba2-7B at full
     width (the shared block every 2 layers, split 2 + 2), 2 clients x 128
     tokens, as phase 14;
 19. the eighth path: LM training of DeepSeek-V2 at full width, as phase
     13 (width 5120, bf16 with the fp32 routers), cut to
     DEEPSEEK_TRAIN_LAYERS (2: the dense MLA prefix layer in each client's
     bottom, one MLA + MoE layer of 160 experts in the top; 3 ran out of
     the card's memory) at JAX's rate, with the wgmma flash kernels at
     (192, 128) (15 forward and 5 backward launches a step), the
     clustering pair and the quantizer as there, the expert products
     grouped with no host read, and the routing of the warm-up steps
     (tokens per expert, the smallest gap between a token's 6th and 7th
     routing probability);
 20. card against CPU on it: one step of a 2-layer fp32 DeepSeek-V2 at
     d_model 1024 (16 heads, 16 experts top 6 with 2 shared, the published
     MLA ranks and head dims, d_ff and vocabulary), 2 clients x 256
     tokens, as phase 14, with every MoE layer call's routing equal;
 21. the ninth path: LM training of Qwen2-VL-7B at full width, as phase
     13 (28 query heads over 4 KV heads of 128, M-RoPE, bf16), cut to
     QWEN2VL_TRAIN_LAYERS (14 of 28, split 3 + 11; 16 ran out of the
     card's memory through the graph), each sequence
     1024 patch embeddings (an image grid of 32 x 32, M-RoPE planes that
     differ) ahead of 3072 tokens (JAX's train_4k shape), the flash
     kernels at GQA 7;
 22. card against CPU on it: one step of a 2-layer fp32 Qwen2-VL-7B at
     full width (split 1 + 1), 2 clients x 128 positions (32 patch
     embeddings, 96 tokens), as phase 14; 22a graph against eager on
     the 2-layer cut in bf16 over GRAPH_SEQ's 2048 positions, as phase
     14a;
 23. the tenth path: LM training of the full SeamlessM4T-medium, as phase
     13: 4096 frames and 1024 decoder tokens a sequence (JAX's train_4k
     shape), the flash kernels at hd 64 (the encoder non-causal, the
     decoder's self-attention causal, its cross-attention 1024 rows over
     4096 frames, non-causal), 3 launches a step per encoder layer and 6
     per decoder layer (teacher, student, recompute), the backward once
     and twice;
 24. card against CPU on it: one step of SeamlessM4T-medium cut to 2
     encoder layers (split 1 + 1) and 1 decoder layer, 2 clients x 256
     frames and 256 decoder tokens, as phase 14; 24a graph against eager
     on that cut in bf16, as phase 14a;
 25. a ``kernels`` JSON line; last, the ``{"ok": true, ...}`` JSON line.
Every profiled run's device records are read raw from the profiler
(``_device_ops``), not through ``key_averages()``.

Needs one CUDA card, ``nvcc`` and this checkout's ``src/``; imports nothing
of JAX."""
from __future__ import annotations

import gc
import importlib
import itertools
import json
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): fp32 outside the tensor cores,
# bf16 in the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# the training round's shapes at the full paper-cnn config: 10 active
# clients x batch 32 anchors against a 2048-entry queue of 64-d features;
# each client's cut tensor is (32, 16, 16, 32)
N_ACTIVE, CLIENT_BATCH, QUEUE, PROJ = 10, 32, 2048, 64
CUT = (CLIENT_BATCH, 16, 16, 32)
# floats of one client's cut tensor at client batch 32 for the models whose
# cut no cluster holds (12 x 12 x 512 and 18 x 18 x 512 a sample): the
# quantizer's two-pass route
VGG_CUTS = {"paper-vgg13": CLIENT_BATCH * 12 * 12 * 512,
            "paper-vgg16": CLIENT_BATCH * 18 * 18 * 512}

# the last two are the LM training step's: 4 anchors (4 clients x 1
# sequence) against H2O-Danube-1.8B's 4096-entry queue at d 128 (the
# kernels' largest d), over 4 labels (positives for every anchor) and over
# its 32000-token vocabulary (the path's sequence pseudo-labels; most
# anchors find no positive)
CLUSTER_TEST_SHAPES = [(16, 64, 16, 4), (64, 256, 32, 10), (100, 512, 64, 7),
                       (32, 1000, 128, 4), (4, 4096, 128, 4),
                       (4, 4096, 128, 32000)]
# the split-and-merge edges of the clustering kernels, as
# tests/test_torch_kernels.py holds their arithmetic: kind -> (b, q, d, m).
# "hole": Q-block 1 has no valid entry and label 0's confident entries lie
# only in the ragged last Q-block (d 30, so the tiles go by plain loads);
# "tail": only the ragged last Q-block has valid entries; "none": no valid
# entry at all (loss 0, dz 0)
CLUSTER_EDGES = {"hole": (100, 1000, 30, 4), "tail": (100, 1000, 64, 4),
                 "none": (64, 256, 16, 4)}

# the serving path: Qwen3-14B, batch 4, a 2048-token prompt, 32 generated
# tokens; its prefill attention is q (4, 40, 2048, 128) over k, v
# (4, 8, 2048, 128) in bf16, causal, once per layer
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
# the tokens of a serving path's profiled run: its decode steps are alike,
# and reading 31 steps' records (above 100k device ops on Qwen3-14B and
# Zamba2-7B) took 16-22 s a path on a slow host
PROFILE_TOKENS = 8

# flash attention against its plain version, in fp32 and bf16:
# (b, h, kvh, sq, skv, hd, causal, window).  The JAX kernel tests' shapes,
# windows and non-causal case, ragged lengths, 5 query heads per KV head;
# then Qwen2-VL-7B's group of 7 query heads per KV head at hd 128, and
# SeamlessM4T's cross-attention at hd 64, non-causal: a training step's
# 1024 decoder rows over 4096 frames, and a decode step's one row over the
# serving path's 2080-row cross cache (SERVE_PROMPT + SERVE_TOKENS)
FLASH_CASES = [
    (1, 2, 1, 128, 128, 64, True, 0), (2, 4, 2, 256, 256, 64, True, 0),
    (1, 8, 8, 256, 256, 128, True, 0), (2, 8, 2, 384, 384, 80, True, 0),
    (1, 4, 4, 256, 256, 112, True, 0), (1, 2, 2, 256, 256, 64, True, 64),
    (1, 2, 2, 256, 256, 64, True, 128), (1, 2, 2, 256, 256, 64, True, 4096),
    (2, 2, 2, 128, 256, 64, False, 0), (1, 10, 2, 200, 200, 128, True, 0),
    (2, 10, 2, 1000, 1000, 128, True, 0), (1, 5, 1, 77, 300, 96, False, 0),
    (1, 4, 2, 33, 33, 32, True, 16), (1, 14, 2, 300, 300, 128, True, 0),
    (1, 16, 16, 1024, 4096, 64, False, 0), (4, 16, 16, 1, 2080, 64, False, 0)]
# bf16 only, for what the wgmma kernel can get wrong: (b, h, kvh, sq, skv,
# hd, causal, window, q scale).  Sq and Skv off the 128-row tiles (1000,
# 129, 77 over 300 non-causal, 300 over 77 causal), a window of 200 across
# tile edges, groups of 5 and 8, a peaked softmax (q scaled by 8, so that P
# rounds near 1); phase 3 adds every head dim and Zamba2-7B's shape.
FLASH_BF16_CASES = [
    (1, 4, 4, 1000, 1000, 128, True, 0, 1.0),
    (2, 4, 2, 129, 129, 128, True, 0, 1.0),
    (1, 5, 1, 77, 300, 128, False, 0, 1.0),
    (1, 4, 2, 300, 77, 112, True, 0, 1.0),
    (1, 4, 2, 1000, 1000, 128, True, 200, 1.0),
    (1, 4, 2, 1000, 1000, 112, True, 200, 1.0),
    (1, 10, 2, 512, 512, 128, True, 0, 1.0),
    (1, 16, 2, 384, 384, 112, True, 0, 1.0),
    (1, 4, 2, 512, 512, 128, True, 0, 8.0),
    (1, 4, 1, 700, 700, 112, True, 0, 8.0)]
# Zamba2-7B's shared attention block: 32 heads of 112, no GQA
ZAMBA_HEADS, ZAMBA_HD = 32, 112
# Qwen2-VL-7B: 28 query heads over 4 KV heads of 128; SeamlessM4T-medium:
# 16 heads of 64, no GQA
QWEN2VL_HEADS, QWEN2VL_KV_HEADS, SEAMLESS_HEADS = 28, 4, 16
# MLA's head-dim pair (q and k 128 nope + 64 rope, v 128), fp32 and bf16:
# (b, h, kvh, sq, skv, causal, window, q scale).  Ragged Sq off the
# 128-row tiles (300, 129), non-causal with Skv != Sq (77 over 300, 300
# over 77), GQA, a window across tile edges, a peaked softmax; phase 3
# adds rows that see no key and DeepSeek-V2's prefill shape, 128 heads
MLA_HD, MLA_HD_V = 192, 128
FLASH_MLA_CASES = [
    (1, 4, 4, 300, 300, True, 0, 1.0), (2, 2, 2, 129, 129, True, 0, 1.0),
    (1, 4, 4, 77, 300, False, 0, 1.0), (1, 2, 2, 300, 77, False, 0, 1.0),
    (1, 4, 2, 256, 256, True, 0, 1.0), (1, 2, 2, 1000, 1000, True, 200, 1.0),
    (1, 4, 4, 512, 512, True, 0, 8.0)]
DEEPSEEK_HEADS = 128
# the reference suite's TOLS (tests/test_kernels.py)
FLASH_TOLS = {"float32": 2e-4, "bfloat16": 3e-2}

# the sLSTM scan against its plain version: (b, s, nh, hd, from a given
# state, forget bias).  The JAX kernel tests' shapes, S = 1, a non-fresh
# state, the xLSTM smoke model's shape (4 heads of 64) and xLSTM-1.3B's
# prefill shape (4 heads of 512 over the 2048-token prompt), the last two
# with the model's forget-gate bias of 3, under which the stabilizer m grows
# by about 3 a step.
SLSTM_CASES = [(2, 64, 2, 32, False, 0.0), (1, 128, 4, 64, False, 0.0),
               (2, 96, 2, 64, False, 0.0), (2, 1, 2, 64, True, 0.0),
               (2, 64, 2, 32, True, 0.0), (4, 256, 4, 64, True, 3.0),
               (SERVE_BATCH, SERVE_PROMPT, 4, 512, False, 3.0)]
# the edges of the kernel's plan on 132 SMs, as SLSTM_CASES: hd 40 over 8
# heads in 14 groups of 3 units, the last of 1; hd 96 over 6 heads in 20
# groups of 5, the last of 1, with B 3, short of one pass of 4 rows; hd 35
# over 8 heads in 12 groups of 3, the last of 2 (h rows read a float at a
# time); B 6 and 9 at the serve width and at hd 64, two and three passes of
# 4 rows, the last ragged.  Phase 3 adds the largest hd the plan admits at
# 4 heads and the serve batch, and the next one, which must raise.
SLSTM_EDGE_CASES = [(2, 100, 8, 40, True, 3.0), (3, 64, 6, 96, False, 0.0),
                    (2, 50, 8, 35, True, 3.0), (6, 128, 4, 512, True, 3.0),
                    (9, 64, 2, 64, False, 0.0)]
# as tests/test_kernels.py holds the Pallas kernel: the recurrent product
# sums in another order
SLSTM_TOL = dict(atol=1e-5, rtol=1e-4)
# the sLSTM backward against its plain version, and the differentiable scan
# against autograd of the plain scan: max|err| / max|ref| per tensor (dwx,
# dR), the forward's rtol.  Both sides are fp32 and sum dh_{t-1} = R dwx_t in
# other orders; the plain fp32 forward and backward at (1, 4096, 4, 512) are
# 3.1e-6 (dwx) and 1.2e-6 (dR) off an fp64 run of the same (measured on a
# CPU).  Cases as SLSTM_CASES: the small ones, the plan's edges, 4 heads of
# 260 (the mma route with 33 groups of 8 units a head, the last of 4: a
# ragged group whose units are a multiple of 4), then xLSTM-1.3B's training
# shapes, a client's bottom (B 1) and the top (B 4) over train_4k's 4096
# tokens from the zero state, and B 2 and 3 at its width
SLSTM_BWD_TOL = 1e-4
SLSTM_BWD_CASES = (SLSTM_CASES[:6] + SLSTM_EDGE_CASES
                   + [(2, 64, 4, 260, True, 3.0),
                      (1, 4096, 4, 512, False, 3.0),
                      (2, 512, 4, 512, True, 3.0),
                      (3, 512, 4, 512, False, 3.0),
                      (4, 4096, 4, 512, False, 3.0)])
# the simt route (the one for an hd past the mma route's fragments) forced
# at the training width, B 1 to 4: one pass of 4 rows, 3 to 0 of them
# padding
SLSTM_BWD_SIMT_CASES = [(b, 128, 4, 512, b % 2 == 1, 3.0)
                        for b in (1, 2, 3, 4)]

# the Mamba2 scan against its plain version: (b, s, nh, hd, n, dtype,
# inputs).  "test": tests/test_kernels.py's distributions (dt in [0.01,
# 0.51], A in [-1, -0.1]), at its shapes, at S = 1 and at ragged S;
# "decay": dt in [2, 4] and A = -1, so that the decay over one of the
# kernel's 64-step chunks passes 88 (exp of it overflows fp32); "model": x,
# B and C bf16 slices of one (B, S, nh hd + 2N) SiLU conv output, dt =
# softplus of N(0, 1), A = -1 and D = 1, as the model at random init hands
# them over.  The last is Zamba2-7B's prefill shape.
# The fp32 cases go to the CUDA-core kernel, the bf16 ones to the mma
# kernel: each fp32 case has a bf16 twin (N 16 and hd 32 padded to 64, S 1,
# ragged S 300 and 1000, 3 heads, one of them alone in its block, "decay").
_MAMBA2_EDGES = [(1, 64, 2, 32, 16, "test"), (2, 128, 4, 64, 64, "test"),
                 (1, 256, 2, 64, 64, "test"), (2, 1, 2, 32, 16, "test"),
                 (2, 300, 2, 32, 16, "test"), (1, 1000, 3, 64, 64, "test"),
                 (2, 256, 2, 64, 64, "decay")]
MAMBA2_CASES = ([(*e[:5], "float32", e[5]) for e in _MAMBA2_EDGES]
                + [(*e[:5], "bfloat16", e[5]) for e in _MAMBA2_EDGES]
                + [(2, 333, 4, 64, 64, "bfloat16", "model"),
                   (SERVE_BATCH, SERVE_PROMPT, 112, 64, 64, "bfloat16",
                    "model")])
# as tests/test_kernels.py holds the Pallas kernel: |err| <= 5e-5 max|y|;
# a bf16 y is rounded once on each side from fp32 values that differ in
# their last bits, so it may also differ by one bf16 ulp (2^-7 of |y|)
MAMBA2_TOL = 5e-5
# the Mamba2 backward against the plain backward: max|err| <= 1e-4 of
# max|ref| per gradient, the sLSTM backward's; both are fp32 inside and sum
# in other orders (the chunked form against the sequential one: on the CPU
# the kernel's arithmetic lies within 1.1e-5 of max|dA| at the "decay"
# inputs, tests/test_torch_zamba_train.py), and a bf16 dx, dB or dC is
# rounded once on each side, so it may also differ by one bf16 ulp (2^-7
# of |x|).  Cases as MAMBA2_CASES: (b, s, nh, hd, n, dtype, inputs), the
# small ones (hd and N off multiples of 8 in fp32 only, where the bf16
# forward refuses them; 3 heads, one alone in its block), the decay, then
# Zamba2-7B's training shapes over train_4k's 4096 tokens, a client's
# bottom (B 1) and the top (B 4), in bf16 (the path) and fp32 (the
# card-vs-CPU check's type)
MAMBA2_BWD_TOL = 1e-4
MAMBA2_BWD_CASES = [(1, 64, 2, 32, 16, "float32", "test"),
                    (2, 300, 2, 32, 16, "float32", "test"),
                    (1, 130, 3, 20, 12, "float32", "test"),
                    (2, 256, 2, 64, 64, "float32", "decay"),
                    (1, 64, 2, 32, 16, "bfloat16", "test"),
                    (2, 300, 2, 32, 16, "bfloat16", "test"),
                    (1, 1000, 3, 64, 64, "bfloat16", "test"),
                    (2, 256, 2, 64, 64, "bfloat16", "decay"),
                    (1, 4096, 112, 64, 64, "bfloat16", "model"),
                    (4, 4096, 112, 64, 64, "bfloat16", "model"),
                    (1, 4096, 112, 64, 64, "float32", "model"),
                    (4, 4096, 112, 64, 64, "float32", "model")]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def l2_bytes() -> int:
    import torch
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   50 << 20)


def cold_copies(t) -> itertools.cycle:
    """A cycle over copies of ``t`` that together hold more than twice the
    card's L2, so that a call on the next copy reads it from HBM, as a bound
    at the HBM rate assumes."""
    copies = 2 * l2_bytes() // (t.numel() * t.element_size()) + 2
    return itertools.cycle([t.clone() for _ in range(copies)])


def time_ms(fn, iters: int = 50, warmup: int = 5,
            by_kernel: dict | None = None) -> tuple[float, float]:
    """(device ms, event ms) per call of ``fn``, after warm-up.  Device ms:
    the kernels' own durations from ``torch.profiler``, summed per call.
    Event ms: CUDA events around back-to-back calls, which is the host's
    enqueue time where that is the longer of the two.  Inputs stay warm in
    L2 unless ``fn`` cycles through :func:`cold_copies`.  ``by_kernel``, if
    given, receives each kernel's device ms per call by profiler name.
    Fails if some kernel that ``fn`` launched has no device record in each
    of the profiles that PROFILE_PADS gives (see :func:`_unrecorded`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    # the profiler drops the device records of a session's first launches,
    # more of them the more sessions the process has profiled (on the H100,
    # late in this script, every record of a Mamba2 backward call's 15
    # launches): each session opens with spin-kernel pads that take those
    # losses, and is profiled again with 4x the pads while a launch of
    # ``fn`` still has no record
    for tries, pads in enumerate(PROFILE_PADS, 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pads):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        missing, launched = _unrecorded(prof, pads)
        if not missing:
            break
        print(f"[timing] torch.profiler kept no device record of {missing} "
              f"of the {launched} launches of {iters} calls behind {pads} "
              f"pads (profile {tries} of {len(PROFILE_PADS)})")
    else:
        fail(f"torch.profiler kept no device record of {missing} of "
             f"{launched} launches in each of {len(PROFILE_PADS)} profiles")
    # every launch has its record; other device ops (a memset) may still
    # lose some, and are counted at the next multiple of ``iters`` at their
    # mean duration.  The records are read raw (_device_ops): a plain
    # version's hundred thousand launches took key_averages() minutes
    dev, lost = 0.0, []
    ops = [op for op in _device_ops(prof) if "spin_kernel" not in op[0]]
    for name, total_s, count in _by_name(ops):
        calls = -(-count // iters) * iters
        if calls != count:
            lost.append(f"{name[:60]} ({count} of {calls})")
        dev += total_s * 1e6 / count * calls
        if by_kernel is not None:
            by_kernel[name] = total_s * 1e3 / count * calls / iters
    if lost:
        print("[timing] torch.profiler lost records of "
              + "; ".join(lost) + "; counted at their mean duration")
    if dev <= 0:
        print("[timing] torch.profiler saw no device time; using the CUDA "
              "event time")
        return event_ms, event_ms
    return dev / 1e3 / iters, event_ms


# the pads of each profile of time_ms, one profile after another
PROFILE_PADS = (256, 1024, 4096, 16384)


def _unrecorded(prof, skip: int) -> tuple[int, int]:
    """(launches with no device record, launches) of a profiled run after
    its first ``skip`` launches: a runtime launch on the host
    (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
    ``cudaLaunchCooperativeKernel``) and the kernel it launched share a
    correlation id.  The host's records are kept where the device's are
    lost (on the H100, torch 2.11, CUDA 12.8)."""
    from torch.autograd import DeviceType
    host, device = [], set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device.add(e.correlation_id())
        elif e.name().startswith("cudaLaunch"):
            host.append((e.start_ns(), e.correlation_id()))
    launched = [c for _, c in sorted(host)[skip:]]
    return sum(c not in device for c in launched), len(launched)


def _device_ops(prof) -> list:
    """(name, start ns, duration ns) of every device op of a profiled run,
    from the profiler's raw records: ``key_averages()`` builds an event
    tree in Python first, which for the hundreds of thousands of records
    of an xLSTM step (or a serving run) takes minutes."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def _busy_s(ops) -> float:
    """Seconds in which the device ran at least one op: the union of the
    ops' intervals.  A replayed CUDA graph may run independent nodes at
    once, so a sum of durations can pass the wall."""
    busy, end = 0, None
    for _, start, dur in sorted(ops, key=lambda op: op[1]):
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy / 1e9


def _by_name(ops) -> list:
    """[(name, total device s, count)] of device ops, largest first."""
    acc: dict[str, list] = {}
    for name, _, dur in ops:
        a = acc.setdefault(name, [0.0, 0])
        a[0] += dur / 1e9
        a[1] += 1
    return sorted(((k, t, c) for k, (t, c) in acc.items()),
                  key=lambda x: -x[1])


def _ours(kernels, names) -> dict:
    """{name: (device s, launches)} of the ops of ``kernels`` (from
    :func:`_by_name`) whose profiler name holds each of ``names``."""
    return {k: (sum(t for n, t, _ in kernels if k in n),
                sum(c for n, _, c in kernels if k in n)) for k in names}


def _host_spans(prof, prefix: str) -> dict:
    """{name: total host s} of the profiled run's spans (``record_function``
    ranges on the host) whose name starts with ``prefix``, from the raw
    records."""
    from torch.autograd import DeviceType
    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(prefix):
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e9
    return out


def bound_ms(n_bytes: float, n_flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> dict:
    """Build every kernel; returns each source's ptxas report."""
    from repro_torch.kernels import build
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    print(f"[build] {nvcc.stdout.strip().splitlines()[-1]}")
    t0 = time.time()
    reports = build.build_all()
    print(f"[build] {len(reports)} libraries built in "
          f"{time.time() - t0:.1f} s into {build.BUILD_DIR}")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")
    return reports


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cluster_inputs(b, q, d, m, seed, normalize=False):
    import torch
    rng = np.random.RandomState(seed)
    z = rng.randn(b, d).astype(np.float32)
    qz = rng.randn(q, d).astype(np.float32)
    if normalize:
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        qz /= np.linalg.norm(qz, axis=1, keepdims=True)
    arrs = (z, rng.randint(0, m, b).astype(np.int64), rng.rand(b) > 0.2, qz,
            rng.randint(0, m, q).astype(np.int32), rng.rand(q) > 0.3,
            rng.rand(q) > 0.1)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrs]


def _cluster_edge_inputs(kind, seed, tile_q):
    """CLUSTER_EDGES[kind] with unit-norm features, as the path's projection
    head gives them; ``tile_q`` is the kernels' Q-block."""
    import torch
    b, q, d, m = CLUSTER_EDGES[kind]
    args = _cluster_inputs(b, q, d, m, seed, normalize=True)
    qlab, qconf, qvalid = args[4:]
    last = (q - 1) // tile_q * tile_q
    if kind == "hole":
        qvalid[tile_q:2 * tile_q] = False
        qconf &= (qlab != 0) | (torch.arange(q, device="cuda") >= last)
    elif kind == "tail":
        qvalid[:last] = False
    else:
        qvalid[:] = False
    return args


def _check_cluster(args, what, errs):
    import torch

    from repro_torch.kernels import clustering_loss, ref
    z = args[0].clone().requires_grad_(True)
    loss_k = clustering_loss(z, *args[1:], 0.1)
    (dz_k,) = torch.autograd.grad(loss_k, z)
    zr = args[0].clone().requires_grad_(True)
    loss_r = ref.clustering_loss_ref(zr, *args[1:], 0.1)
    (dz_r,) = torch.autograd.grad(loss_r, zr)
    torch.cuda.synchronize()
    loss_k, loss_r = float(loss_k.detach()), float(loss_r.detach())
    le = abs(loss_k - loss_r)
    de = float((dz_k - dz_r).abs().max())
    print(f"[kernels] clustering {what}: loss {loss_k:.6f} vs "
          f"{loss_r:.6f} |err| {le:.3g}; dz max|err| {de:.3g}")
    if not le <= 1e-5 * max(1.0, abs(loss_r)):
        fail(f"clustering loss {what} differs by {le}")
    if not torch.allclose(dz_k, dz_r, atol=1e-5, rtol=1e-4):
        fail(f"clustering dz {what} differs by {de}")
    errs["clustering_fwd"] = max(errs["clustering_fwd"], le)
    errs["clustering_bwd"] = max(errs["clustering_bwd"], de)


def _quant_plans(xf, per_slice):
    """Every route that can take ``xf``: the fused one where a cluster
    holds a slice, and the two-pass one always."""
    from repro_torch.kernels import quantize as q
    s, n = q.slices(xf, per_slice)
    n_sm, smem, per_sm = q.card_limits(0)
    fused = q.fused_plan(s, n, smem)
    return ([fused] if fused else []) + [q.two_pass_plan(s, n, n_sm, per_sm)]


def _route_name(p, fmt) -> str:
    from repro_torch.kernels import quantize as q
    if p.route == "fused":
        return (f"fused (C {p.cluster}, {p.blocks} blocks, {p.smem_bytes} B "
                f"of shared memory a block, "
                f"{q.resident_clusters(0, p.cluster, p.share_bytes, fmt)} "
                f"clusters resident)")
    return f"two-pass ({p.parts} partials a slice, {p.blocks} amax blocks)"


def _check_quant(x, fmt, per_slice, what, errs):
    """The public wrapper (the plan's route) and each route that can take
    ``x``, bit for bit against the plain version, each route's amax too,
    and two launches of each route bit-identical."""
    import torch

    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import quantize_dequantize, ref
    out_r = ref.quantize_dequantize_ref(x, fmt, per_slice=per_slice)
    amax_r = ref.slice_amax(x.float(), per_slice).reshape(-1)
    bits = lambda t: t.view(torch.int32)
    out_k = quantize_dequantize(x, fmt, per_slice=per_slice)
    torch.cuda.synchronize()
    xf = x.to(torch.float32).contiguous()
    chosen = q.plan_for(xf, per_slice).route
    if not torch.equal(bits(out_k), bits(out_r)):
        fail(f"quantize {fmt} {what} through the wrapper ({chosen}) is not "
             f"bit-exact")
    for p in _quant_plans(xf, per_slice):
        amax_k = torch.full((p.slices,), -1.0, device=x.device)
        out = q.run(xf, fmt, p, amax_k)
        again = q.run(xf, fmt, p)
        torch.cuda.synchronize()
        same = torch.equal(bits(out), bits(out_r))
        ae = float((amax_k - amax_r).abs().max())
        oe = float((out - out_r).abs().max())
        rerun = torch.equal(bits(out), bits(again))
        print(f"[kernels] quantize {fmt} {what} {_route_name(p, fmt)}"
              f"{' (the plan)' if p.route == chosen else ''}: bit-exact "
              f"{same}, amax max|err| {ae:.3g}, out max|err| {oe:.3g}, two "
              f"launches bit-identical {rerun}")
        if not (same and ae == 0.0 and rerun):
            fail(f"quantize {fmt} {what} by the {p.route} route is not "
                 f"bit-exact")
        found = ({"quantize_fused": max(oe, ae)} if p.route == "fused"
                 else {"quantize_amax": ae, "quantize_qdq": oe})
        for name, e in found.items():
            errs[name] = max(errs[name], e)


def _check_lm_cut(fmt: str, errs: dict) -> None:
    """The LM training step's wire: H2O-Danube-1.8B's cut features, one
    (LM_SEQ, d_model) slice a client, bf16.  ``_check_quant`` on their
    fp32 copy (what the wrapper hands the kernels), then the wrapper on
    the bf16 tensor itself, bit for bit against the plain version."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import quantize_dequantize, ref
    cut = LM_SEQ * get_config(LM_ARCH).d_model
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(LM_CLIENTS, cut, generator=gen, device="cuda").to(
        torch.bfloat16)
    _check_quant(x.float(), fmt, True, f"({LM_CLIENTS}, {cut}) per slice, "
                 f"{LM_ARCH}'s cut", errs)
    got = quantize_dequantize(x, fmt, per_slice=True)
    want = ref.quantize_dequantize_ref(x, fmt, per_slice=True)
    same = (got.dtype == torch.bfloat16
            and torch.equal(got.view(torch.int16), want.view(torch.int16)))
    print(f"[kernels] quantize {fmt} ({LM_CLIENTS}, {cut}) bf16 through the "
          f"wrapper: bit-exact {same}")
    if not same:
        fail(f"quantize {fmt} of {LM_ARCH}'s bf16 cut is not bit-exact")


def _fmt_ms(v) -> str:
    return "n/a" if v is None else f"{v[0]:.5f} ms (events {v[1]:.5f} ms)"


def _time_quant(card: str, xf) -> dict:
    """The quantizer's timings, every version on inputs read from HBM (its
    bound is the HBM rate; the fused kernel also warm in L2, as the round's
    cut tensors, just written, often are): the fused kernel at the round's
    shape, and the two-pass kernels at the round's and each VGG cut's.
    Returns the rows of the ``kernels`` line: the fused kernel at the
    round's shape, the two-pass ones at paper-vgg13's, the cut of the path
    that launches them."""
    import torch

    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import ref
    n_sm, smem, per_sm = q.card_limits(0)
    s, n = xf.shape[0], xf.numel() // xf.shape[0]
    fp = q.fused_plan(s, n, smem)
    xc = cold_copies(xf)
    print(f"[timing] quantizer inputs cycle through copies of "
          f"{xf.numel() * 4 / 1e6:.1f} MB, more than twice the L2 of "
          f"{l2_bytes() / 1e6:.1f} MB")
    warm = time_ms(lambda: q.quantize_fused(xf, "int8", fp))
    rows = {"quantize_fused": dict(
        ms=time_ms(lambda: q.quantize_fused(next(xc), "int8", fp)),
        plain_ms=time_ms(lambda: ref.quantize_dequantize_ref(
            next(xc), "int8", per_slice=True)),
        library_ms=None, bound=bound_ms(2 * s * n * 4 + s * 4, 7 * s * n))}
    t = rows["quantize_fused"]
    print(f"[timing] quantize_fused at ({s}, {n}), {_route_name(fp, 'int8')}"
          f": from HBM {_fmt_ms(t['ms'])}, warm in L2 {_fmt_ms(warm)}, "
          f"bound {t['bound'][0]:.5f} ms, share of bound from HBM "
          f"{t['bound'][0] / t['ms'][0]:.3f}, warm "
          f"{t['bound'][0] / warm[0]:.3f} on {card}")
    # where a cold launch's time goes (the diagnostic build's stamps), and
    # how the rate grows with the clusters, one a slice, that run at once
    for _ in range(3):
        stamps = q.fused_profile(next(xc), "int8", fp)
    med = lambda v: float(np.median(v))
    stored = stamps[q.PHASES[-1]]
    last = [max(stored[i * fp.cluster:(i + 1) * fp.cluster])
            for i in range(s)]
    print(f"[timing] quantize_fused phases of a launch from HBM, ns after "
          f"the first block's start (median, max over {fp.blocks} blocks): "
          + "; ".join(f"{k} {med(v):.0f}, {max(v):.0f}"
                      for k, v in stamps.items())
          + f"; stores issued by each slice's last block: {last} on {card}")
    del xc
    wide = torch.randn(14, n, device="cuda")
    rates = []
    for k in (1, 2, 4, 6, 8, 10, 12, 14):
        kp = q.fused_plan(k, n, smem)
        kc = cold_copies(wide[:k])
        ms = time_ms(lambda: q.quantize_fused(next(kc), "int8", kp))[0]
        rates.append(f"{k} {ms:.5f} ms {2 * k * n * 4 / ms / 1e9:.3f} TB/s")
        del kc
    print(f"[timing] quantize_fused from HBM by slices of {n} (clusters of "
          f"{fp.cluster}, one a slice): " + ", ".join(rates) + f" on {card}")
    del wide
    shapes = {"paper-cnn": n, **VGG_CUTS}
    for arch, n in shapes.items():
        x = (xf.view(s, n) if arch == "paper-cnn"
             else torch.randn(s, n, device="cuda"))
        tp = q.two_pass_plan(s, n, n_sm, per_sm)
        partial = q.quantize_amax(x, tp)
        amax = partial.amax(dim=1)
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        zp = torch.zeros(s, dtype=torch.int32, device="cuda")
        xc = cold_copies(x)
        two = {
            "quantize_amax": dict(
                ms=time_ms(lambda: q.quantize_amax(next(xc), tp)),
                plain_ms=time_ms(lambda: ref.slice_amax(next(xc), True)),
                library_ms=time_ms(lambda: torch.linalg.vector_norm(
                    next(xc), ord=float("inf"), dim=1)),
                bound=bound_ms(s * n * 4 + s * tp.parts * 4, 2 * s * n)),
            "quantize_qdq": dict(
                ms=time_ms(lambda: q.quantize_qdq(next(xc), partial, "int8",
                                                  tp)),
                plain_ms=time_ms(lambda: ref.qdq_from_amax(next(xc), amax,
                                                           "int8")),
                library_ms=time_ms(
                    lambda: torch.fake_quantize_per_channel_affine(
                        next(xc), scale, zp, 0, -127, 127)),
                bound=bound_ms(2 * s * n * 4 + s * tp.parts * 4, 5 * s * n)),
        }
        for name, t in two.items():
            print(f"[timing] {name} at {arch}'s cut ({s}, {n}), "
                  f"{_route_name(tp, 'int8')}: kernel {_fmt_ms(t['ms'])}, "
                  f"plain {_fmt_ms(t['plain_ms'])}, library "
                  f"{_fmt_ms(t['library_ms'])}, bound {t['bound'][0]:.5f} ms "
                  f"({t['bound'][1]}), share of bound "
                  f"{t['bound'][0] / t['ms'][0]:.3f} on {card}")
        if arch == "paper-vgg13":
            rows.update(two)
        del x, xc, partial
    return rows


def phase_kernels(card: str, ptxas: str) -> dict:
    import torch

    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import ref

    # the package's ``clustering_loss`` attribute is the public wrapper
    cl = importlib.import_module("repro_torch.kernels.clustering_loss")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[kernels] clustering ptxas: {line.strip()}")
    b, qn = N_ACTIVE * CLIENT_BATCH, QUEUE
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = cl.blocks_per_sm(PROJ)
    grid = (cl.q_blocks(qn), -(-b // cl.TILE_B))
    print(f"[kernels] clustering at ({b}, {qn}, {PROJ}): partial kernels' "
          f"grid {grid[0]} Q-blocks x {grid[1]} B-tiles = "
          f"{grid[0] * grid[1]} blocks of {cl.TILE_B} anchors x "
          f"{cl.TILE_Q} queue entries on {n_sm} SMs, resident per SM: "
          f"forward {per_sm[0]}, backward {per_sm[1]}; merges: forward 1 "
          f"block of 512 threads, backward {-(-b // 8)} blocks of 256")
    if min(per_sm) < 1:
        fail("a clustering partial kernel cannot be resident on an SM")
    errs = dict.fromkeys(("clustering_fwd", "clustering_bwd",
                          "quantize_fused", "quantize_amax", "quantize_qdq"),
                         0.0)
    for b, qn, d, m in CLUSTER_TEST_SHAPES:
        _check_cluster(_cluster_inputs(b, qn, d, m, b + qn),
                       f"({b}, {qn}, {d})", errs)
    for i, kind in enumerate(CLUSTER_EDGES):
        _check_cluster(_cluster_edge_inputs(kind, 20 + i, cl.TILE_Q),
                       f"{kind} {CLUSTER_EDGES[kind][:3]}", errs)
    # the LM step's shape with unit-norm features, as its projection head
    # gives them
    _check_cluster(_cluster_inputs(4, 4096, 128, 4, 8, normalize=True),
                   "(4, 4096, 128) unit norm", errs)
    # where the 16-byte loads do not fit: d 1, and queue rows off 16 bytes
    _check_cluster(_cluster_inputs(16, 300, 1, 3, 5), "(16, 300, 1)", errs)
    args = _cluster_inputs(100, 1000, 64, 7, 6)
    flat = torch.empty(args[3].numel() + 1, device="cuda")
    flat[1:] = args[3].reshape(-1)
    args[3] = flat[1:].view(args[3].shape)
    _check_cluster(args, "(100, 1000, 64), queue rows off 16 bytes", errs)
    dev = torch.device("cuda")
    empty = [torch.ones(4, 8, device=dev), torch.zeros(4, dtype=torch.int64,
                                                       device=dev),
             torch.ones(4, dtype=torch.bool, device=dev),
             torch.ones(16, 8, device=dev),
             torch.zeros(16, dtype=torch.int32, device=dev),
             torch.zeros(16, dtype=torch.bool, device=dev),
             torch.zeros(16, dtype=torch.bool, device=dev)]
    loss0 = cl.ClusteringLoss.apply(*empty, 0.1)
    if float(loss0) != 0.0:
        fail(f"empty queue gives loss {float(loss0)}, want 0")
    print("[kernels] clustering empty queue: loss 0.0")
    big = _cluster_inputs(N_ACTIVE * CLIENT_BATCH, QUEUE, PROJ, 10, 11,
                          normalize=True)
    _check_cluster(big, f"({N_ACTIVE * CLIENT_BATCH}, {QUEUE}, {PROJ})", errs)
    # the merges run in a fixed order: two launches give the same bits
    inputs = cl._prepare(*big)
    g = torch.ones((), device=dev)
    runs = []
    for _ in range(2):
        loss, lse, n_pos, denom = cl.clustering_fwd(inputs, 10.0)
        runs.append((loss, lse, cl.clustering_bwd(inputs, 10.0, lse, n_pos,
                                                  g, denom)))
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"[kernels] clustering two launches at {tuple(big[0].shape)} x "
          f"{tuple(big[3].shape)}: loss, lse and dz bit-identical {same}")
    if not same:
        fail("two launches of the clustering kernels on the same inputs "
             "differ")
    del runs

    rng = np.random.RandomState(3)
    batch = rng.randn(N_ACTIVE, *CUT).astype(np.float32)
    batch[1] *= 1e-3
    batch[2] = 0.0                                   # an all-zero slice
    batch[3].flat[5] = np.abs(batch[3]).max() * 2    # x == amax exactly
    batch[3].flat[9] = -batch[3].flat[5]
    batch[4].flat[100:164] = -0.0                    # signed zeros pass
    xb = torch.from_numpy(batch).cuda()
    ragged = torch.from_numpy(rng.randn(1000).astype(np.float32)).cuda()
    ragged_b = torch.from_numpy(rng.randn(3, 333).astype(np.float32)).cuda()
    # the round's batch off 16 bytes: the fused route's ragged ends in every
    # share, and its scalar stores
    off = torch.empty(xb.numel() + 1, device=dev)
    off[1:] = xb.reshape(-1)
    off = off[1:].view(xb.shape)
    # the fused route's largest slice on this card, and one float more
    n_sm, smem, _ = q.card_limits(0)
    n_max = q.MAX_CLUSTER * ((smem - q.SCRATCH_BYTES) // 16 * 4)
    edge = torch.tensor([448.0, -448.0, 1.0, 447.0, -3.5], device=dev)
    for fmt in ("int8", "fp8"):
        _check_quant(xb, fmt, True, f"{tuple(xb.shape)} per slice", errs)
        _check_quant(off, fmt, True, f"{tuple(xb.shape)} off 16 bytes", errs)
        _check_quant(ragged, fmt, False, "(1000,)", errs)
        _check_quant(ragged_b, fmt, True, "(3, 333) per slice", errs)
        _check_quant(torch.zeros(N_ACTIVE, 64, device=dev), fmt, True,
                     "all zeros", errs)
        for n in (n_max, n_max + 1):
            _check_quant(torch.randn(2, n, device=dev), fmt, True,
                         f"(2, {n}) per slice", errs)
        for cut in VGG_CUTS.values():
            _check_quant(torch.randn(N_ACTIVE, cut, device=dev), fmt, True,
                         f"({N_ACTIVE}, {cut}) per slice", errs)
        _check_lm_cut(fmt, errs)
    _check_quant(edge, "fp8", False, "at +-448", errs)
    e8 = q.quantize_dequantize_cuda(edge, "fp8")
    if float(e8[0]) != 448.0 or float(e8[1]) != -448.0:
        fail(f"fp8 at +-448 gives {e8.tolist()}")
    print(f"[kernels] fp8 at +-448: {e8.tolist()} == plain")

    # timings at the training round's shapes
    inv_t = 10.0
    loss, lse, n_pos, denom = cl.clustering_fwd(inputs, inv_t)
    zr = big[0].clone().requires_grad_(True)
    loss_r = ref.clustering_loss_ref(zr, *big[1:], 0.1)
    b, qn = N_ACTIVE * CLIENT_BATCH, QUEUE
    n_valid = int(big[6].sum())
    n_has = int((n_pos > 0).sum())
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    # the clustering pair is bound by its operations, whose rate does not
    # depend on where the inputs lie; the quantizer's versions are timed on
    # inputs read from HBM (_time_quant)
    parts = {"clustering_fwd": {}, "clustering_bwd": {}}
    timings = {
        "clustering_fwd": dict(
            ms=time_ms(lambda: cl.clustering_fwd(inputs, inv_t),
                       by_kernel=parts["clustering_fwd"]),
            plain_ms=time_ms(lambda: ref.clustering_loss_ref(*big, 0.1)),
            library_ms=None,
            bound=bound_ms(in_bytes + 3 * b * 4 + 8,
                           2 * b * n_valid * PROJ)),
        "clustering_bwd": dict(
            ms=time_ms(lambda: cl.clustering_bwd(inputs, inv_t, lse, n_pos,
                                                 g, denom),
                       by_kernel=parts["clustering_bwd"]),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                loss_r, zr, retain_graph=True)),
            library_ms=None,
            bound=bound_ms(in_bytes + 2 * b * 4 + 8 + b * PROJ * 4,
                           4 * n_has * n_valid * PROJ)),
    }
    del loss
    timings.update(_time_quant(card, xb.contiguous()))
    for name, t in timings.items():
        print(f"[timing] {name}: kernel {_fmt_ms(t['ms'])}, plain "
              f"{_fmt_ms(t['plain_ms'])}, library {_fmt_ms(t['library_ms'])}, "
              f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}) on {card}")
        for k in ("ms", "plain_ms", "library_ms"):
            t[k] = None if t[k] is None else t[k][0]
    short = lambda key: (re.findall(r"clustering_[a-z_]+", key)
                         or [key[:40]])[0]
    for name, by in parts.items():
        print(f"[timing] {name} by kernel: " + ", ".join(
            f"{short(k)} {v:.4f} ms" for k, v in by.items()) + f" on {card}")
    return {"errs": errs, "timings": timings}


def _attn_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs that attention leaves unmasked."""
    import torch
    q_pos = torch.arange(sq)[:, None]
    kv_pos = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    return int(mask.sum())


def _sdpa_backend(kernels: dict) -> str:
    """The backend ``scaled_dot_product_attention`` took, named from the
    device kernels the profiler recorded for its calls."""
    names = " ".join(kernels).lower()
    for key, backend in (("cudnn", "cuDNN"), ("flash", "flash"),
                         ("fmha", "memory-efficient"),
                         ("efficient", "memory-efficient")):
        if key in names:
            return backend
    return "math"


def _time_flash(card: str, model: str, h: int, kvh: int, hd: int,
                check, hd_v: int = 0, causal: bool = True,
                sq: int = SERVE_PROMPT, skv: int = SERVE_PROMPT) -> dict:
    """Check, then time, the bf16 kernel at ``model``'s prefill shape in the
    model's layout: (B, S, heads, hd) projections handed over as (B, heads,
    S, hd) views (v's head dim ``hd_v``, if given), causal unless
    ``causal`` is False, Sq ``sq`` over Skv ``skv``.  Kernel, plain
    version, one ``scaled_dot_product_attention`` call (with the backend
    PyTorch picks for it named) and the bound; printed, never a reason to
    fail."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    hd_v = hd_v or hd
    gen = torch.Generator(device="cuda").manual_seed(hd)
    b, bf = SERVE_BATCH, torch.bfloat16
    view = lambda n, s, d=hd: torch.randn(b, s, n, d, generator=gen,
                                          device="cuda").to(bf).transpose(1, 2)
    q, k, v = view(h, sq), view(kvh, skv), view(kvh, skv, hd_v)
    kind = "causal" if causal else "non-causal"
    err = check(q, k, v, f"{model} prefill shape bf16 q {tuple(q.shape)} kv "
                f"{tuple(k.shape)}"
                + (f" v {tuple(v.shape)}" if hd_v != hd else "")
                + f" {kind} (strided views)", FLASH_TOLS["bfloat16"],
                causal=causal)[1]
    # q, k and v read once, the (B, H, Sq, hd_v) output written once
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v)) \
        + b * h * sq * hd_v * 2
    n_flops = 2 * b * h * (hd + hd_v) * _attn_pairs(sq, skv, causal, 0)
    lib_kernels: dict = {}
    t = dict(
        ms=time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                   iters=20, warmup=3),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), iters=5, warmup=1),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), iters=20, warmup=3,
            by_kernel=lib_kernels),
        bound=bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS))
    print(f"[timing] flash_attention at {model}'s prefill: the library call "
          f"takes the {_sdpa_backend(lib_kernels)} backend; its kernels "
          + ", ".join(f"{n[:70]} {ms:.4f} ms" for n, ms in
                      lib_kernels.items()))
    print(f"[timing] flash_attention at {model}'s prefill, q "
          f"{tuple(q.shape)} kv {tuple(k.shape)}"
          + (f" v {tuple(v.shape)}" if hd_v != hd else "") + f" bf16 {kind} "
          f"({n_flops:.4g} operations, {n_bytes / 1e6:.1f} MB): kernel "
          f"{t['ms'][0]:.4f} ms (events {t['ms'][1]:.4f}), plain "
          f"{t['plain_ms'][0]:.4f} ms (events {t['plain_ms'][1]:.4f}), "
          f"library (scaled_dot_product_attention) {t['library_ms'][0]:.4f} "
          f"ms (events {t['library_ms'][1]:.4f}), bound {t['bound'][0]:.4f} "
          f"ms ({t['bound'][1]}); kernel at "
          f"{n_flops / t['ms'][0] / 1e9:.1f} TFLOP/s, "
          f"{t['bound'][0] / t['ms'][0]:.3f} of the bound, "
          f"{t['ms'][0] / t['library_ms'][0]:.2f}x the library's time; "
          f"on {card}")
    for key in ("ms", "plain_ms", "library_ms"):
        t[key] = t[key][0]
    return {"err": err, "timing": t}


def phase_flash(card: str) -> dict:
    """Flash attention against its plain version on the card: every
    ``FLASH_CASES`` entry in fp32 (the CUDA-core kernel) and bf16 (the
    wgmma kernel), the bf16-only cases and every head dim in bf16, MLA's
    (192, 128) pair in both types, rows that see no key in both types (at
    an equal head dim and at the pair); then checked and timed at
    Qwen3-14B's, Zamba2-7B's and DeepSeek-V2's prefill shapes.  Each bf16
    check must launch the wgmma kernel once."""
    import torch

    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(12)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    bf = torch.bfloat16
    err = 0.0

    def check(q, k, v, what, tol, causal=True, window=0):
        before = fa.LAUNCHES["flash_attention_wgmma"]
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        print(f"[kernels] flash {what}: max|err| {e:.3g} (tol {tol})")
        layout = fa.output_like(q, v.shape[-1]).stride()
        if got.dtype != q.dtype or got.stride() != layout \
                or got.shape != want.shape:
            fail(f"flash {what}: output {got.dtype} {tuple(got.shape)} "
                 f"{got.stride()}, want {q.dtype} {tuple(want.shape)} "
                 f"{layout}")
        if fa.LAUNCHES["flash_attention_wgmma"] - before != (q.dtype == bf):
            fail(f"flash {what}: the wgmma kernel ran "
                 f"{fa.LAUNCHES['flash_attention_wgmma'] - before} times")
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"flash attention {what} differs from the plain version by "
                 f"{e}")
        return got, e

    def case(dt, tol, b, h, kvh, sq, skv, hd, causal, window, scale=1.0,
             hd_v=None):
        hd_v = hd_v or hd
        q = (randn(b, h, sq, hd) * scale).to(dt)
        k, v = randn(b, kvh, skv, hd).to(dt), randn(b, kvh, skv, hd_v).to(dt)
        what = (f"{dt} q ({b}, {h}, {sq}, {hd}) kv ({kvh}, {skv}"
                + (f", v {hd_v}" if hd_v != hd else "")
                + f") causal={causal} window={window}"
                + (f" q x {scale:g}" if scale != 1.0 else ""))
        return check(q, k, v, what, tol, causal, window)[1]

    for dname, tol in FLASH_TOLS.items():
        for c in FLASH_CASES:
            err = max(err, case(getattr(torch, dname), tol, *c))
    tol = FLASH_TOLS["bfloat16"]
    for c in FLASH_BF16_CASES:
        err = max(err, case(bf, tol, *c))
    for hd in fa.HEAD_DIMS:
        err = max(err, case(bf, tol, 1, 4, 2, 300, 300, hd, True, 0))
    # MLA's (192, 128) pair in both types, then as the MLA prefill hands it
    # over: views of (B, S, H, d) projections
    for dname, tol in FLASH_TOLS.items():
        for b, h, kvh, sq, skv, causal, window, scale in FLASH_MLA_CASES:
            err = max(err, case(getattr(torch, dname), tol, b, h, kvh, sq,
                                skv, MLA_HD, causal, window, scale,
                                hd_v=MLA_HD_V))
    mla_view = lambda n, d: torch.randn(2, 300, n, d, generator=gen,
                                        device="cuda").to(bf).transpose(1, 2)
    got, e = check(mla_view(8, MLA_HD), mla_view(8, MLA_HD),
                   mla_view(8, MLA_HD_V), "bf16 MLA views q, k (2, 8, 300, "
                   "192) v (2, 8, 300, 128) of (B, S, H, d) projections",
                   FLASH_TOLS["bfloat16"])
    err = max(err, e)
    # causal over 16 keys with a window of 8: rows 23 on see no key -> 0,
    # at an equal head dim and at MLA's pair
    for dname, tol in FLASH_TOLS.items():
        dt = getattr(torch, dname)
        for hd, hd_v in ((32, 32), (MLA_HD, MLA_HD_V)):
            q, k = randn(1, 2, 64, hd).to(dt), randn(1, 1, 16, hd).to(dt)
            v = k if hd_v == hd else randn(1, 1, 16, hd_v).to(dt)
            got, _ = check(q, k, v, f"{dname} rows that see no key, hd "
                           f"{hd}/{hd_v}", tol, window=8)
            if float(got[:, :, 23:].abs().max()) != 0.0:
                fail(f"flash attention ({dname}, hd {hd}/{hd_v}): a row "
                     "that sees no key is not 0")

    # the serving paths' shapes; the first is the kernel's row in the
    # ``kernels`` line
    qwen = _time_flash(card, "Qwen3-14B", 40, 8, 128, check)
    zamba = _time_flash(card, "Zamba2-7B", ZAMBA_HEADS, ZAMBA_HEADS,
                        ZAMBA_HD, check)
    deepseek = _time_flash(card, "DeepSeek-V2", DEEPSEEK_HEADS,
                           DEEPSEEK_HEADS, MLA_HD, check, hd_v=MLA_HD_V)
    # Qwen2-VL-7B's prefill (28 query heads over 4 KV heads of 128; the
    # prompt's 2048 positions, its 8 patch embeddings left out), and
    # SeamlessM4T-medium's: the encoder's non-causal self-attention over the
    # 2048 frames, a decode step's cross-attention (one row over the
    # 2080-row cross cache)
    vl = _time_flash(card, "Qwen2-VL-7B", QWEN2VL_HEADS, QWEN2VL_KV_HEADS,
                     128, check)
    enc = _time_flash(card, "SeamlessM4T-medium's encoder", SEAMLESS_HEADS,
                      SEAMLESS_HEADS, 64, check, causal=False)
    cross = _time_flash(card, "SeamlessM4T-medium's decode step (cross)",
                        SEAMLESS_HEADS, SEAMLESS_HEADS, 64, check,
                        causal=False, sq=1,
                        skv=SERVE_PROMPT + SERVE_TOKENS)
    # a cross-attention decode step as the model hands it over: one query
    # row of the (B, 1, H, hd) projection over a layer's K/V slice of the
    # (L, B, max_len, KVH, hd) cross cache
    cache = randn(2, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                  SEAMLESS_HEADS, 64).to(bf)
    q1 = randn(SERVE_BATCH, 1, SEAMLESS_HEADS, 64).to(bf).transpose(1, 2)
    _, e = check(q1, cache[0].transpose(1, 2), cache[1].transpose(1, 2), "bf16 cross-attention decode "
                 "views q (4, 16, 1, 64) over a layer's slice of the cross "
                 "cache (L, 4, 2080, 16, 64)", FLASH_TOLS["bfloat16"],
                 causal=False)
    return {"err": max(err, e, qwen["err"], zamba["err"], deepseek["err"],
                       vl["err"], enc["err"], cross["err"]),
            "timing": qwen["timing"]}


def _slstm_inputs(b, s, nh, hd, with_state, f_bias, seed):
    """wx as the model holds it, a (B, S, 4d) tensor viewed as (B, S, 4,
    nh, hd); r as the model draws it; a non-fresh state or None."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    wx = (randn(b, s, 4 * nh * hd) * 0.5).view(b, s, 4, nh, hd)
    wx[:, :, 2] += f_bias
    r = randn(nh, hd, 4 * hd) / hd ** 0.5
    state = None
    if with_state:
        state = (torch.tanh(randn(b, nh, hd)), randn(b, nh, hd),
                 torch.rand(b, nh, hd, generator=gen, device="cuda") * 2 + 0.5,
                 randn(b, nh, hd) * 2)
    return wx, r, state


def _check_slstm(case, seed) -> float:
    """One case against the plain version: h and the final (h, c, n, m)
    within SLSTM_TOL.  The stabilizer m is a running sum (about 3 a step
    under the model's forget bias), so its error is shown beside its size;
    the returned max|err| is over h and the final h, c and n, whose size is
    about 1."""
    import torch

    from repro_torch.kernels import ref
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    b, s, nh, hd, with_state, f_bias = case
    wx, r, state = _slstm_inputs(b, s, nh, hd, with_state, f_bias, seed)
    got = sl.slstm_scan_cuda(wx, r, state)
    want = ref.slstm_scan_ref(wx, r, state)
    torch.cuda.synchronize()
    outs = zip(("h", "h_T", "c_T", "n_T", "m_T"), (got[0], *got[1]),
               (want[0], *want[1]))
    errs = {}
    for name, g, w in outs:
        errs[name] = float((g - w).abs().max())
        if not torch.allclose(g, w, **SLSTM_TOL):
            fail(f"slstm scan ({b}, {s}, {nh}, {hd}) state={with_state}: "
                 f"{name} differs from the plain version by {errs[name]}")
    p = sl.plan(b, nh, hd, *sl.card_limits(0))
    print(f"[kernels] slstm ({b}, {s}, 4, {nh}, {hd}) from "
          f"{'a given' if with_state else 'the zero'} state, forget bias "
          f"{f_bias}, {p.blocks} blocks of {p.units} units x {p.slices} "
          f"slices: max|err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (max|m_T| {float(want[1][3].abs().max()):.4g}; tol "
          f"atol {SLSTM_TOL['atol']} rtol {SLSTM_TOL['rtol']})")
    return max(errs[k] for k in ("h", "h_T", "c_T", "n_T"))


def phase_slstm(card: str, ptxas: str) -> dict:
    """The sLSTM scan against its plain version on the card, h and the
    final (h, c, n, m), at SLSTM_CASES, at the plan's edges and at the
    largest hd the plan admits; the next hd must raise before any launch,
    and two launches on the same inputs must agree bit for bit.  Then timed
    at xLSTM-1.3B's prefill shape and at S 512 beside it, for the cost of a
    step, and that step split into its phases by the kernel's diagnostic
    build."""
    import torch

    from repro_torch.kernels import ref
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    n_sm, smem_optin = sl.card_limits(0)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[kernels] slstm ptxas: {line.strip()}")
    err = 0.0
    for i, case in enumerate(SLSTM_CASES):
        err = max(err, _check_slstm(case, 20 + i))
    for i, case in enumerate(SLSTM_EDGE_CASES):
        err = max(err, _check_slstm(case, 40 + i))
    for refused in itertools.count(512):
        try:
            sl.plan(SERVE_BATCH, 4, refused, n_sm, smem_optin)
        except ValueError:
            break
    err = max(err, _check_slstm(
        (SERVE_BATCH, 256, 4, refused - 1, True, 3.0), 50))
    for hd in (refused, 1024):
        wx, r, _ = _slstm_inputs(SERVE_BATCH, 8, 4, hd, False, 0.0, 51)
        before = sl.LAUNCHES["slstm_scan"]
        try:
            sl.slstm_scan_cuda(wx, r)
        except ValueError as e:
            print(f"[kernels] slstm at 4 heads of {hd} raises: {e}")
        else:
            fail(f"slstm scan at 4 heads of {hd} did not raise")
        torch.cuda.synchronize()
        if sl.LAUNCHES["slstm_scan"] != before:
            fail(f"slstm scan at 4 heads of {hd} launched before raising")

    # the serving path's shape: its SLSTM_CASES inputs, from a given state
    wx, r, state = _slstm_inputs(SERVE_BATCH, SERVE_PROMPT, 4, 512, True,
                                 3.0, 26)
    one, two = (sl.slstm_scan_cuda(wx, r, state) for _ in range(2))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip((one[0], *one[1]),
                                                 (two[0], *two[1])))
    print(f"[kernels] slstm two launches at wx {tuple(wx.shape)}: h and the "
          f"final state bit-identical {same}")
    if not same:
        fail("two launches of the slstm scan on the same inputs differ")
    del one, two, state
    b, s, nh, hd = wx.shape[0], wx.shape[1], wx.shape[3], wx.shape[4]
    n_bytes = (wx.numel() + r.numel() + b * s * nh * hd + 4 * b * nh * hd) * 4
    n_flops = 2 * b * s * nh * hd * 4 * hd
    t = dict(
        ms=time_ms(lambda: sl.slstm_scan_cuda(wx, r), iters=20, warmup=3),
        plain_ms=time_ms(lambda: ref.slstm_scan_ref(wx, r), iters=2,
                         warmup=1),
        library_ms=None,
        bound=bound_ms(n_bytes, n_flops))
    short = wx[:, :512]
    ms_short = time_ms(lambda: sl.slstm_scan_cuda(short, r), iters=20,
                       warmup=3)[0]
    step_us = (t["ms"][0] - ms_short) / (s - 512) * 1e3
    p = sl.plan(b, nh, hd, n_sm, smem_optin)
    print(f"[timing] slstm_scan at wx {tuple(wx.shape)} fp32 "
          f"({n_flops:.4g} operations, {n_bytes / 1e6:.1f} MB): kernel "
          f"{t['ms'][0]:.4f} ms (events {t['ms'][1]:.4f}), plain "
          f"{t['plain_ms'][0]:.4f} ms (events {t['plain_ms'][1]:.4f}), "
          f"library n/a (no single PyTorch call), bound {t['bound'][0]:.4f} "
          f"ms ({t['bound'][1]}); kernel at "
          f"{n_flops / t['ms'][0] / 1e9:.3f} TFLOP/s, "
          f"{t['bound'][0] / t['ms'][0]:.4f} of the bound, on {card}")
    print(f"[timing] slstm_scan per step: S 512 {ms_short:.4f} ms, S {s} "
          f"{t['ms'][0]:.4f} ms, slope {step_us:.4f} us a step; plan: "
          f"{p.blocks} blocks of {p.units} units x {p.slices} slices = "
          f"{p.threads} threads, {p.r_bytes} bytes of R and {p.smem_bytes} "
          f"bytes of shared memory a block (the card allows {smem_optin}, "
          f"{n_sm} SMs)")
    # where a step goes, in SM clocks, from the kernel's diagnostic build
    phases = sl.step_profile(wx, r)
    total = sum(phases.values())
    barrier = (phases["wait for the head's blocks"] + phases["publish"])
    sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[timing] slstm_scan step profile (SM clocks a step, first "
          f"block, SLSTM_PROFILE build; SM clock {sm_mhz}): "
          + ", ".join(f"{k} {v:.0f}" for k, v in phases.items())
          + f"; total {total:.0f}; the barrier (wait + publish) "
          f"{barrier / total:.3f} of it, the h exchange (load) "
          f"{phases['h_{t-1} loaded'] / total:.3f}")
    for key in ("ms", "plain_ms"):
        t[key] = t[key][0]
    return {"err": err, "timing": t}


def _rel_err(got, want, abs_errs: list) -> float:
    """max|got - want| / max|want|; max|got - want| goes to ``abs_errs``."""
    err = (got - want).abs().max()
    abs_errs.append(float(err))
    return float(err / want.abs().max().clamp(min=1e-30))


def _check_slstm_bwd(case, seed, route=None) -> float:
    """One case: the training forward's saved pre-activations and (c, n, m)
    against the plain scan's (SLSTM_TOL); the backward kernel (on ``route``
    if given, else the plan's) against the plain backward on the same saved
    tensors, dwx, dh_0 and dR (dR as the Function forms it from dwx); then,
    on the plan's route, :class:`SLSTMScan` (both kernels) against autograd
    of the plain scan on the card, dwx and dR; each max|err| / max|ref|
    within SLSTM_BWD_TOL.  Returns the largest max|err|."""
    import torch

    from repro_torch.kernels import ref
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    b, s, nh, hd, with_state, f_bias = case
    t0 = time.perf_counter()
    wx, r, state = _slstm_inputs(b, s, nh, hd, with_state, f_bias, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dh = torch.randn(b, s, nh, hd, generator=gen, device="cuda")
    h, _, saved = sl.slstm_scan_cuda(wx, r, state, save=True)
    _, _, want_saved = ref.slstm_scan_ref(wx, r, state, save=True)
    for name, g, w in zip(("pre", "c", "n", "m"), saved, want_saved):
        if not torch.allclose(g, w, **SLSTM_TOL):
            fail(f"slstm scan ({b}, {s}, {nh}, {hd}) saves {name} "
                 f"{float((g - w).abs().max())} off the plain scan's")
    p = sl.plan_bwd(b, nh, hd, *sl.card_limits(0), route=route)
    dwx, dh0 = sl.slstm_scan_bwd_cuda(r, *saved, state, dh, plan=p)
    want_dwx, want_dh0 = ref.slstm_scan_bwd_ref(r, *saved, state, dh)
    h0, abs_errs = state and state[0], []
    errs = {"dwx": _rel_err(dwx, want_dwx, abs_errs),
            "dh0": _rel_err(dh0, want_dh0, abs_errs),
            "dR": _rel_err(ref.slstm_dr(h, h0, dwx),
                           ref.slstm_dr(h, h0, want_dwx), abs_errs)}
    if route is None:
        # the Function against autograd of the plain scan, each its own
        # forward
        wx_g, r_g = wx.clone().requires_grad_(), r.clone().requires_grad_()
        h_g, *_ = sl.SLSTMScan.apply(wx_g, r_g, *(state or (None,) * 4))
        h_g.backward(dh)
        wx_a, r_a = wx.clone().requires_grad_(), r.clone().requires_grad_()
        ref.slstm_scan_ref(wx_a, r_a, state)[0].backward(dh)
        errs["fn dwx"] = _rel_err(wx_g.grad, wx_a.grad, abs_errs)
        errs["fn dR"] = _rel_err(r_g.grad, r_a.grad, abs_errs)
    torch.cuda.synchronize()
    print(f"[kernels] slstm backward ({b}, {s}, 4, {nh}, {hd}) from "
          f"{'a given' if with_state else 'the zero'} state, forget bias "
          f"{f_bias}, route {p.route}{' (forced)' if route else ''}, "
          f"{p.blocks} blocks of {p.units} units x {p.slices} "
          f"{'m-tiles' if p.route == 'mma' else 'slices'}: "
          f"max|err| / max|ref| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (max|dwx| {float(want_dwx.abs().max()):.4g}, largest "
          f"max|err| {max(abs_errs):.3g}; tol {SLSTM_BWD_TOL}; "
          f"{time.perf_counter() - t0:.1f} s)")
    bad = {k: v for k, v in errs.items() if not v <= SLSTM_BWD_TOL}
    if bad:
        fail(f"slstm backward ({b}, {s}, {nh}, {hd}) state={with_state}: "
             f"{bad} over {SLSTM_BWD_TOL} of max|ref|")
    return max(abs_errs)


def phase_slstm_bwd(card: str, ptxas: str) -> dict:
    """The sLSTM backward kernel against its plain version on the card at
    SLSTM_BWD_CASES on the plan's route (and the Function against autograd
    of the plain scan), and at SLSTM_BWD_SIMT_CASES on the simt route; the
    largest hd the plan admits at 4 heads and the serve batch (the simt
    route) and the next one, which must raise before any launch.  Then at
    the top's shape (B 4) and a bottom's (B 1): two launches must agree bit
    for bit; the SM clocks of each phase of a step, of the first design
    (the simt route) and of the plan's route; both timed in turns, the
    plan's against the plain backward and the bound (its product at the
    bf16 tensor-core peak on the mma route, at the fp32 CUDA-core peak on
    the simt route)."""
    import torch

    from repro_torch.kernels import ref
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    n_sm, smem_optin = sl.card_limits(0)
    for kernel in ("slstm_scan_bwd_mma", "slstm_scan_bwd_kernel"):
        for row in _ptxas_rows(ptxas, kernel):
            print(f"[kernels] slstm backward ptxas: {row}")
    err = 0.0
    for i, case in enumerate(SLSTM_BWD_CASES):
        err = max(err, _check_slstm_bwd(case, 60 + i))
    for i, case in enumerate(SLSTM_BWD_SIMT_CASES):
        err = max(err, _check_slstm_bwd(case, 90 + i, route="simt"))
    for refused in itertools.count(512):
        try:
            sl.plan_bwd(SERVE_BATCH, 4, refused, n_sm, smem_optin)
        except ValueError:
            break
    err = max(err, _check_slstm_bwd(
        (SERVE_BATCH, 64, 4, refused - 1, True, 3.0), 80))
    wx, r, _ = _slstm_inputs(SERVE_BATCH, 8, 4, refused, False, 0.0, 81)
    _, _, saved = sl.slstm_scan_cuda(wx, r, save=True)
    before = sl.LAUNCHES["slstm_scan_bwd"]
    try:
        sl.slstm_scan_bwd_cuda(r, *saved, None, torch.ones_like(saved[1]))
    except ValueError as e:
        print(f"[kernels] slstm backward at 4 heads of {refused} raises: {e}")
    else:
        fail(f"slstm backward at 4 heads of {refused} did not raise")
    torch.cuda.synchronize()
    if sl.LAUNCHES["slstm_scan_bwd"] != before:
        fail(f"slstm backward at 4 heads of {refused} launched before "
             f"raising")
    del wx, r, saved

    timing = None
    s, nh, hd = LM_SEQ, 4, 512
    for b in (LM_CLIENTS, 1):
        wx, r, _ = _slstm_inputs(b, s, nh, hd, False, 3.0, 82 + b)
        _, _, saved = sl.slstm_scan_cuda(wx, r, save=True)
        dh = torch.randn(b, s, nh, hd, device="cuda")
        one, two = (sl.slstm_scan_bwd_cuda(r, *saved, None, dh)
                    for _ in range(2))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(one, two))
        print(f"[kernels] slstm backward two launches at pre "
              f"{tuple(saved[0].shape)}: dwx and dh_0 bit-identical {same}")
        if not same:
            fail("two launches of the slstm backward on the same inputs "
                 "differ")
        del one, two
        plans = {"first design": sl.plan_bwd(b, nh, hd, n_sm, smem_optin,
                                             route="simt"),
                 "plan": sl.plan_bwd(b, nh, hd, n_sm, smem_optin)}
        for what, p in plans.items():
            prof = sl.bwd_step_profile(r, *saved, dh, plan=p)
            print(f"[profile] slstm backward step at B {b}, {what} (route "
                  f"{p.route}): SM clocks "
                  f"{sum(prof.values()):.1f} = "
                  + ", ".join(f"{k} {v:.1f}" for k, v in prof.items())
                  + f"; on {card}")
        d = nh * hd
        n_bytes = 12 * b * s * d * 4 + r.numel() * 4
        n_flops = 2 * b * s * nh * hd * 4 * hd
        # the plan and the first design in turns (plan, first, first,
        # plan); the plain version (about 4 s a call, host-bound) is timed
        # at the top's shape only, once after a warm-up call
        ms = {what: [] for what in plans}
        for what in ("plan", "first design", "first design", "plan"):
            ms[what].append(time_ms(lambda: sl.slstm_scan_bwd_cuda(
                r, *saved, None, dh, plan=plans[what]), iters=10, warmup=2))
        t = dict(ms=min(ms["plan"]),
                 plain_ms=(time_ms(lambda: ref.slstm_scan_bwd_ref(
                     r, *saved, None, dh), iters=1, warmup=1)
                     if timing is None else (float("nan"),) * 2),
                 library_ms=None,
                 bound=bound_ms(n_bytes, n_flops,
                                PEAK_BF16_FLOPS if plans["plan"].route == "mma"
                                else PEAK_FP32_FLOPS))
        p = plans["plan"]
        print(f"[timing] slstm_scan_bwd at pre {tuple(saved[0].shape)} fp32 "
              f"({n_flops:.4g} operations, {n_bytes / 1e6:.1f} MB): kernel "
              f"{t['ms'][0]:.4f} ms (events {t['ms'][1]:.4f}; "
              f"{t['ms'][0] / s * 1e3:.4f} us a step; runs "
              + ", ".join(f"{v[0]:.4f}" for v in ms["plan"])
              + "), the first design (simt) "
              + ", ".join(f"{v[0]:.4f}" for v in ms["first design"])
              + ", "
              + (f"plain {t['plain_ms'][0]:.4f} ms (events "
                 f"{t['plain_ms'][1]:.4f}), " if timing is None
                 else "plain not timed at this shape, ")
              + f"library n/a (no single PyTorch call), bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}; the product "
              f"{n_flops / PEAK_BF16_FLOPS * 1e3:.4f} ms at the bf16 "
              f"tensor-core peak, {n_flops / PEAK_FP32_FLOPS * 1e3:.4f} at "
              f"the fp32 CUDA-core peak, the bytes "
              f"{n_bytes / PEAK_BYTES * 1e3:.4f}); kernel at "
              f"{n_flops / t['ms'][0] / 1e9:.3f} TFLOP/s, "
              f"{t['bound'][0] / t['ms'][0]:.4f} of the bound; plan: route "
              f"{p.route}, {p.blocks} blocks of {p.units} units, "
              f"{p.threads} threads, {p.smem_bytes} bytes of shared memory "
              f"a block; on {card}")
        if timing is None:             # the top's shape goes in the row
            timing = {"ms": t["ms"][0], "plain_ms": t["plain_ms"][0],
                      "library_ms": None, "bound": t["bound"]}
        del wx, r, saved, dh
    return {"err": err, "timing": timing}


def _mamba2_inputs(b, s, nh, hd, n, dtype, kind, seed):
    """x, dt, A, B, C, D for one case; x, B and C are views of one (B, S,
    nh hd + 2N) tensor, as the model's conv output hands them over."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(seed)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    rand = lambda *shape: torch.rand(*shape, generator=gen, device="cuda")
    d_in = nh * hd
    conv = randn(b, s, d_in + 2 * n)
    if kind == "model":
        conv = F.silu(conv)
        dt = F.softplus(randn(b, s, nh))
        A, D = -torch.ones(nh, device="cuda"), torch.ones(nh, device="cuda")
    elif kind == "decay":
        dt = rand(b, s, nh) * 2 + 2
        A, D = -torch.ones(nh, device="cuda"), rand(nh)
    else:
        dt = rand(b, s, nh) * 0.5 + 0.01
        A, D = -(rand(nh) * 0.9 + 0.1), rand(nh)
    conv = conv.to(getattr(torch, dtype))
    x = conv[..., :d_in].reshape(b, s, nh, hd)
    return (x, dt, A, conv[..., d_in:d_in + n], conv[..., d_in + n:], D)


def _check_mamba2(m2, args, case) -> float:
    """One case against the plain version: y and the final state, finite,
    of the right shape and type, within MAMBA2_TOL of max|.| (y in bf16
    also within 2^-7 of |y|, the state at rtol 0); a bf16 case must launch
    the mma kernel, an fp32 one the CUDA-core kernel."""
    import torch

    from repro_torch.kernels import ref
    b, s, nh, hd, n, dtype, kind = case
    before = dict(m2.LAUNCHES)
    y, state = m2.mamba2_scan_cuda(*args)
    y_r, state_r = ref.mamba2_scan_ref(*args)
    torch.cuda.synchronize()
    mma = m2.LAUNCHES["mamba2_scan_mma"] - before["mamba2_scan_mma"]
    if mma != (dtype == "bfloat16"):
        fail(f"mamba2 scan {kind} ({b}, {s}, {nh}, {hd}, {n}) {dtype} "
             f"launched the mma kernel {mma} times")
    if y.dtype != args[0].dtype or y.shape != y_r.shape \
            or state.shape != (b, nh, hd, n):
        fail(f"mamba2 scan ({b}, {s}, {nh}, {hd}, {n}): y {y.dtype} "
             f"{tuple(y.shape)}, state {tuple(state.shape)}")
    errs = {}
    for name, g, w in (("y", y.float(), y_r.float()),
                       ("state", state, state_r)):
        if not bool(torch.isfinite(g).all()):
            fail(f"mamba2 scan {kind} ({b}, {s}, {nh}, {hd}, {n}): "
                 f"non-finite {name}")
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max())
        rtol = 2 ** -7 if (name, dtype) == ("y", "bfloat16") else 0.0
        if not torch.allclose(g, w, atol=MAMBA2_TOL * scale, rtol=rtol):
            fail(f"mamba2 scan {kind} ({b}, {s}, {nh}, {hd}, {n}) "
                 f"{dtype}: {name} differs from the plain version by "
                 f"{errs[name]} (max|{name}| {scale})")
        errs[f"max|{name}|"] = scale
    cum = (args[1][:, :64] * args[2]).sum(1).min()
    print(f"[kernels] mamba2 {kind} x ({b}, {s}, {nh}, {hd}) N {n} "
          f"{dtype} ({'mma' if mma else 'CUDA-core'} kernel): max|err| y "
          f"{errs['y']:.3g} (max|y| {errs['max|y|']:.4g}), state "
          f"{errs['state']:.3g} (max|state| {errs['max|state|']:.4g}, "
          f"{errs['state'] / errs['max|state|']:.3g} of it); decay over "
          f"the first 64 steps down to {float(cum):.4g}; tol {MAMBA2_TOL} "
          f"of max|.|" + (", plus 2^-7 of |y|" if dtype == "bfloat16"
                          else ""))
    return max(errs["y"], errs["state"])


def phase_mamba2(card: str, ptxas: str) -> dict:
    """The Mamba2 scan against its plain version on the card, y and the
    final state, at MAMBA2_CASES (fp32 through the CUDA-core kernel, bf16
    through the mma kernel); a bf16 view the mma kernel cannot read must
    raise before any launch, and two launches at Zamba2-7B's prefill shape
    must agree bit for bit.  Then timed at that shape, and a chunk of the
    mma kernel split into its phases by its diagnostic build."""
    import torch

    from repro_torch.kernels import ref
    m2 = importlib.import_module("repro_torch.kernels.mamba2_scan")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[kernels] mamba2 ptxas: {line.strip()}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = m2.mma_blocks_per_sm()
    blocks = SERVE_BATCH * -(-112 // 2)
    print(f"[kernels] mamba2 mma kernel: {per_sm} blocks of 256 threads "
          f"resident per SM, {per_sm * n_sm} on {n_sm} SMs, for the serve "
          f"shape's {blocks} blocks ({-(-blocks // (per_sm * n_sm))} "
          f"wave(s))")
    if per_sm < 1:
        fail("the mamba2 mma kernel cannot be resident on an SM")
    err = 0.0
    for i, case in enumerate(MAMBA2_CASES):
        args = _mamba2_inputs(*case, 40 + i)
        err = max(err, _check_mamba2(m2, args, case))

    # a bf16 view the cp.async loads cannot read: x one element off
    x, dt, A, B, C, D = _mamba2_inputs(1, 64, 2, 32, 16, "bfloat16", "test",
                                       60)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device="cuda")
    shifted = flat[1:].view(x.shape)
    before = dict(m2.LAUNCHES)
    try:
        m2.mamba2_scan_cuda(shifted, dt, A, B, C, D)
    except ValueError as e:
        print(f"[kernels] mamba2 on a misaligned bf16 x raises: {e}")
    else:
        fail("the mamba2 scan took a bf16 x its loads cannot read")
    torch.cuda.synchronize()
    if m2.LAUNCHES != before:
        fail("the mamba2 scan launched before refusing a misaligned x")

    # the serving path's shape, from its last case's inputs
    x, dt, A, B, C, D = args
    one, two = (m2.mamba2_scan_cuda(*args) for _ in range(2))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(one, two))
    print(f"[kernels] mamba2 two launches at x {tuple(x.shape)}: y and the "
          f"final state bit-identical {same}")
    if not same:
        fail("two launches of the mamba2 scan on the same inputs differ")
    del one, two
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    el = x.element_size()
    n_bytes = (2 * x.numel() * el + dt.numel() * 4 + 2 * b * s * n * el
               + b * nh * hd * n * 4 + 2 * nh * 4)
    n_flops = 4 * b * s * nh * hd * n
    t = dict(
        ms=time_ms(lambda: m2.mamba2_scan_cuda(*args), iters=20, warmup=3),
        plain_ms=time_ms(lambda: ref.mamba2_scan_ref(*args), iters=2,
                         warmup=1),
        library_ms=None,
        bound=bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS))
    print(f"[timing] mamba2_scan at x {tuple(x.shape)} N {n} bf16, mma "
          f"kernel ({n_flops:.4g} inter-chunk operations, "
          f"{n_bytes / 1e6:.1f} MB): kernel {t['ms'][0]:.4f} ms (events "
          f"{t['ms'][1]:.4f}), plain {t['plain_ms'][0]:.4f} ms (events "
          f"{t['plain_ms'][1]:.4f}), library n/a (no single PyTorch call), "
          f"bound {t['bound'][0]:.4f} ms ({t['bound'][1]}); kernel at "
          f"{n_bytes / t['ms'][0] / 1e6:.1f} GB/s, "
          f"{t['ms'][0] / t['bound'][0]:.2f}x the bound (target <= 5x), on "
          f"{card}")
    # where a chunk goes, in SM clocks, from the kernel's diagnostic build
    per_warp = m2.chunk_profile(*args)
    phases = {k: sum(v) / len(v) for k, v in per_warp.items()}
    total = sum(phases.values())
    sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[timing] mamba2_scan chunk profile (SM clocks a chunk, mean over "
          f"block (0, 0)'s 8 warps, MAMBA2_PROFILE build; SM clock "
          f"{sm_mhz}): " + ", ".join(f"{k} {v:.0f} ({v / total:.3f})"
                                     for k, v in phases.items())
          + f"; total {total:.0f}")
    print("[timing] mamba2_scan chunk profile by warp (warps 0-3 head 0, "
          "4-7 head 1): " + "; ".join(
              f"{k} " + " ".join(f"{c:.0f}" for c in v)
              for k, v in per_warp.items()))
    for key in ("ms", "plain_ms"):
        t[key] = t[key][0]
    return {"err": err, "timing": t}


def _bwd_routes(m2, x, B, dtype: str) -> dict:
    """{route: plan} of every route the backward's plan gives a case: a
    bf16 case takes the mma route (the plan's) and the simt route forced;
    an fp32 case the simt route."""
    b, s, nh, hd = x.shape
    routes = ("mma", "simt") if dtype == "bfloat16" else ("simt",)
    return {r: m2.plan_bwd(x.dtype, b, s, nh, hd, B.shape[-1], route=r)
            for r in routes}


def _check_mamba2_train(m2, args, case, seed) -> float:
    """One case of the scan's training pair: the forward's training variant
    (y and the final state equal to the serving variant's bit for bit, the
    chunk states against the plain recurrence's within MAMBA2_TOL of
    max|state|), then the backward on those saved states through each route
    the plan gives the case (:func:`_bwd_routes`; the plan's own first)
    against the plain backward, each gradient within MAMBA2_BWD_TOL of
    max|ref| (plus 2^-7 of |ref| where it is bf16), each call counted once
    and on the mma route also in its own count.  Returns the largest
    max|err|."""
    import torch

    from repro_torch.kernels import ref
    b, s, nh, hd, n, dtype, kind = case
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn(b, s, nh, hd, generator=gen, device="cuda").to(
        args[0].dtype)
    y0, final0 = m2.mamba2_scan_cuda(*args)
    y, final, states = m2.mamba2_scan_cuda(*args, save=True)
    if not (torch.equal(y, y0) and torch.equal(final, final0)):
        fail(f"mamba2 training forward {case}: y or the final state differs "
             "from the serving variant's")
    _, _, want_states = ref.mamba2_scan_ref(*args, chunk=m2.CHUNK)
    s_scale = float(want_states.abs().max())
    s_err = float((states - want_states).abs().max())
    if not s_err <= MAMBA2_TOL * max(s_scale, 1e-30):
        fail(f"mamba2 training forward {case}: chunk states {s_err} off the "
             f"plain recurrence's (max|state| {s_scale})")
    del y0, final0, y, final, want_states
    want = ref.mamba2_scan_bwd_ref(*args, dy)
    plans = _bwd_routes(m2, args[0], args[3], dtype)
    if next(iter(plans)) != m2.plan_bwd(args[0].dtype, b, s, nh, hd,
                                        n).route:
        fail(f"mamba2 backward {case}: the plan's route is not "
             f"{next(iter(plans))}")
    worst = 0.0
    for route, p in plans.items():
        before = dict(m2.LAUNCHES)
        got = m2.mamba2_scan_bwd_cuda(*args, states, dy, plan=p)
        torch.cuda.synchronize()
        mma = m2.LAUNCHES["mamba2_scan_bwd_mma"] - before["mamba2_scan_bwd_mma"]
        if m2.LAUNCHES["mamba2_scan_bwd"] != before["mamba2_scan_bwd"] + 1 \
                or mma != (route == "mma"):
            fail(f"mamba2 backward {case} on the {route} route: counted "
                 f"{m2.LAUNCHES['mamba2_scan_bwd'] - before['mamba2_scan_bwd']}"
                 f" times, {mma} on the mma route")
        errs = {}
        for name, g, w, like in zip(("dx", "ddt", "dA", "dB", "dC", "dD"),
                                    got, want, args[:6]):
            if g.dtype != like.dtype or g.shape != like.shape:
                fail(f"mamba2 backward {case} ({route}): {name} {g.dtype} "
                     f"{tuple(g.shape)}, want {like.dtype} "
                     f"{tuple(like.shape)}")
            a, r = g.float(), w.float()
            if not bool(torch.isfinite(a).all()):
                fail(f"mamba2 backward {case} ({route}): non-finite {name}")
            scale = max(float(r.abs().max()), 1e-30)
            e = float((a - r).abs().max())
            worst = max(worst, e)
            errs[name] = e / scale
            rtol = 2 ** -7 if g.dtype == torch.bfloat16 else 0.0
            if not torch.allclose(a, r, atol=MAMBA2_BWD_TOL * scale,
                                  rtol=rtol):
                fail(f"mamba2 backward {case} ({route} route): {name} "
                     f"differs from the plain version by {e} (max|{name}| "
                     f"{scale})")
        print(f"[kernels] mamba2 backward {kind} x ({b}, {s}, {nh}, {hd}) N "
              f"{n} {dtype}, {route} route"
              + (" (the plan's)" if route == next(iter(plans)) else "")
              + f": chunk states {s_err:.3g} off (max|state| "
              f"{s_scale:.4g}); max|err| / max|ref| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (tol {MAMBA2_BWD_TOL}"
              + (", plus 2^-7 of |x| for dx, dB, dC" if dtype == "bfloat16"
                 else "") + ")")
        del got
    print(f"[kernels] mamba2 backward {kind} case checked in "
          f"{time.perf_counter() - t0:.1f} s")
    return worst


def phase_mamba2_bwd(card: str, ptxas: str) -> dict:
    """The scan's training pair on the card: the backward's ptxas report
    and the mma route's residency; the forward's training variant and the
    backward at MAMBA2_BWD_CASES through every route the plan gives each
    (:func:`_check_mamba2_train`: bf16 on the mma route and the simt route
    forced, fp32 on the simt route); :class:`Mamba2Scan` against autograd
    of the plain scan at a small shape in both types (bf16 on the mma
    route); two launches of each route at the top's shape must agree bit
    for bit; then at the top's shape (B 4) and a bottom's (B 1), bf16, the
    SM clocks of each phase of a chunk of both designs (the diagnostic
    build) and both routes timed in turns (mma, simt, simt, mma), against
    the plain backward and the bound (the function's bytes and products,
    the products at the bf16 tensor-core peak of the inputs' type, the
    three that all heads share counted once a batch row and chunk).
    Returns the largest error and the rows of the kernels line: the
    backward's (every call) and the mma route's, both timed on the plan's
    route at the top's shape."""
    import torch

    from repro_torch.kernels import ref
    m2 = importlib.import_module("repro_torch.kernels.mamba2_scan")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[kernels] mamba2 backward ptxas: {line.strip()}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm, clusters = m2.bwd_mma_residency()
    for b in (LM_CLIENTS, 1):
        p = m2.plan_bwd(torch.bfloat16, b, LM_SEQ, 112, 64, 64)
        blocks = p.grid[0] * p.grid[1]
        print(f"[kernels] mamba2 backward mma route at B {b}: {blocks} blocks "
              f"of {p.threads} threads in clusters of {p.cluster}, "
              f"{p.smem_bytes} bytes of shared memory a block; {per_sm} "
              f"blocks resident an SM, {clusters} clusters of "
              f"{p.cluster} on the card at once ({per_sm * n_sm} block slots "
              f"on {n_sm} SMs: {blocks / (per_sm * n_sm):.2f} of them); "
              f"{p.groups} partial sets a batch row and chunk, "
              f"{p.scratch_floats * 4 / 1e6:.1f} MB of scratch; the simt "
              f"route's {m2.plan_bwd(torch.bfloat16, b, LM_SEQ, 112, 64, 64, route='simt').grid} "
              f"blocks, 1 an SM")
    if per_sm < 2 or clusters < 1:
        fail(f"the mamba2 backward's mma kernel: {per_sm} blocks an SM, "
             f"{clusters} clusters resident")
    err = 0.0
    for i, case in enumerate(MAMBA2_BWD_CASES):
        args = _mamba2_inputs(*case, 70 + i)
        err = max(err, _check_mamba2_train(m2, args, case, 170 + i))
        del args
        torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        args = _mamba2_inputs(2, 300, 4, 64, 64, dtype, "model", 90)
        gen = torch.Generator(device="cuda").manual_seed(91)
        dy = torch.randn(2, 300, 4, 64, generator=gen, device="cuda").to(
            args[0].dtype)
        got = [a.detach().clone().requires_grad_() for a in args]
        before = m2.LAUNCHES["mamba2_scan_bwd_mma"]
        y, final = m2.Mamba2Scan.apply(*got)
        if final.requires_grad:
            fail("Mamba2Scan's final state carries a gradient")
        y.backward(dy)
        if m2.LAUNCHES["mamba2_scan_bwd_mma"] - before != (dtype ==
                                                           "bfloat16"):
            fail(f"Mamba2Scan {dtype} did not take the plan's route")
        want = [a.detach().clone().requires_grad_() for a in args]
        ref.mamba2_scan_ref(*want)[0].backward(dy)
        errs = []
        for a, w in zip(got, want):
            g, r = a.grad.float(), w.grad.float()
            scale = max(float(r.abs().max()), 1e-30)
            errs.append(float((g - r).abs().max()) / scale)
            rtol = 2 ** -7 if a.dtype == torch.bfloat16 else 0.0
            if not torch.allclose(g, r, atol=MAMBA2_BWD_TOL * scale,
                                  rtol=rtol):
                fail(f"Mamba2Scan {dtype}: a gradient differs from autograd "
                     f"of the plain scan by {errs[-1]} of its max")
        print(f"[kernels] Mamba2Scan {dtype} x (2, 300, 4, 64) against "
              f"autograd of the plain scan: max|err| / max|ref| "
              + ", ".join(f"{e:.3g}" for e in errs))

    timing = None
    sm_mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for b in (LM_CLIENTS, 1):
        args = _mamba2_inputs(b, LM_SEQ, 112, 64, 64, "bfloat16", "model",
                              92 + b)
        x = args[0]
        _, _, states = m2.mamba2_scan_cuda(*args, save=True)
        dy = torch.randn(x.shape, device="cuda").to(x.dtype)
        plans = _bwd_routes(m2, x, args[3], "bfloat16")
        if b == LM_CLIENTS:
            # the forward's two variants in turns (serving, training,
            # training, serving): the training one also writes the chunk
            # states
            fwd = {True: [], False: []}
            for save in (False, True, True, False):
                fwd[save].append(time_ms(lambda: m2.mamba2_scan_cuda(
                    *args, save=save), iters=20, warmup=3))
            runs = lambda v: ", ".join(f"{d:.4f} / {e:.4f}" for d, e in v)
            print(f"[timing] mamba2_scan at x {tuple(x.shape)} bf16, device "
                  f"/ event ms a call: the serving variant "
                  f"{runs(fwd[False])}, the training variant "
                  f"{runs(fwd[True])} (it also writes "
                  f"{states.numel() * 4 / 1e6:.1f} MB of chunk states); on "
                  f"{card}")
            for route, p in plans.items():
                one, two = (m2.mamba2_scan_bwd_cuda(*args, states, dy,
                                                    plan=p)
                            for _ in range(2))
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in zip(one, two))
                print(f"[kernels] mamba2 backward two launches at x "
                      f"{tuple(x.shape)}, {route} route: every gradient "
                      f"bit-identical {same}")
                if not same:
                    fail(f"two launches of the mamba2 backward's {route} "
                         f"route on the same inputs differ")
                del one, two
        for route, p in plans.items():
            prof = m2.bwd_profile(*args, states, dy, plan=p)
            total = sum(prof.values())
            print(f"[profile] mamba2 backward chunk at B {b}, {route} route"
                  + (" (the first design)" if route == "simt" else "")
                  + f" (SM clocks a chunk, block (0, 0)'s thread 0, "
                  f"MAMBA2_BWD_PROFILE build; SM clock {sm_mhz}): "
                  f"{total:.0f} = " + ", ".join(
                      f"{k} {v:.0f} ({v / total:.3f})"
                      for k, v in prof.items()) + f"; on {card}")
        s, nh, hd, n = LM_SEQ, 112, 64, 64
        nc = m2.chunks(s)
        el = x.element_size()
        n_bytes = (3 * x.numel() * el + states.numel() * 4
                   + 2 * b * s * nh * 4 + 4 * b * s * n * el + 4 * nh * 4)
        # what the function needs: six 64 x 64 x 64 products a head and
        # chunk, and three a chunk that all heads share (C B^T, dCB B,
        # dCB^T C), whatever route implements it
        n_flops = 2 * 64 ** 3 * (6 * b * nh * nc + 3 * b * nc)
        # the simt route's own products on the CUDA cores in fp32, the
        # shared ones repeated in each of its blocks of BWD_HEADS heads
        simt_fp32_s = 2 * 64 ** 3 * (6 * b * nh * nc + 3 * b * nc
                                     * -(-nh // m2.BWD_HEADS)) \
            / PEAK_FP32_FLOPS
        # both routes in turns (mma, simt, simt, mma), each kernel's device
        # time from the profiler
        ms = {r: [] for r in plans}
        per_kernel = {r: {} for r in plans}
        for r in ("mma", "simt", "simt", "mma"):
            ms[r].append(time_ms(lambda: m2.mamba2_scan_bwd_cuda(
                *args, states, dy, plan=plans[r]), iters=5, warmup=1,
                by_kernel=per_kernel[r]))
        t = dict(ms=min(ms["mma"]),
                 plain_ms=(time_ms(lambda: ref.mamba2_scan_bwd_ref(*args, dy),
                                   iters=1, warmup=0)
                           if timing is None else (float("nan"),) * 2),
                 bound=bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS))
        kern = lambda r: ", ".join(f"{k.split('(')[0][-40:]} {v:.4f}"
                                   for k, v in per_kernel[r].items())
        print(f"[timing] mamba2_scan_bwd at x {tuple(x.shape)} N {n} bf16 "
              f"({n_flops:.4g} operations in its products, "
              f"{n_bytes / 1e6:.1f} MB): the mma route (the plan's) "
              + ", ".join(f"{d:.4f}" for d, _ in ms["mma"])
              + " ms (events " + ", ".join(f"{e:.4f}" for _, e in ms["mma"])
              + f"; by kernel {kern('mma')}), the simt route (the first "
              f"design) " + ", ".join(f"{d:.4f}" for d, _ in ms["simt"])
              + " ms (events " + ", ".join(f"{e:.4f}" for _, e in ms["simt"])
              + f"; by kernel {kern('simt')}), "
              + (f"plain {t['plain_ms'][0]:.4f} ms (events "
                 f"{t['plain_ms'][1]:.4f}), " if timing is None
                 else "plain not timed at this shape, ")
              + f"library n/a (no single PyTorch call), bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}; the bytes "
              f"{n_bytes / PEAK_BYTES * 1e3:.4f} ms, the products "
              f"{n_flops / PEAK_BF16_FLOPS * 1e3:.4f} ms at the bf16 "
              f"tensor-core peak the mma route runs on; the simt route's "
              f"own products, the shared ones in each of its blocks, "
              f"{simt_fp32_s * 1e3:.4f} ms at the fp32 CUDA-core peak it "
              f"runs on); the mma route at "
              f"{n_flops / t['ms'][0] / 1e9:.3f} TFLOP/s, "
              f"{t['bound'][0] / t['ms'][0]:.4f} of the bound, "
              f"{min(ms['simt'])[0] / t['ms'][0]:.2f}x faster than the "
              f"simt route; on {card}")
        if timing is None:             # the top's shape goes in the rows
            timing = {"ms": t["ms"][0], "plain_ms": t["plain_ms"][0],
                      "library_ms": None, "bound": t["bound"]}
        del args, x, states, dy
        torch.cuda.empty_cache()
    return {"err": err, "timing": timing}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

MAIN_PATH = dict(smoke=False, n_clients=20, n_active=N_ACTIVE,
                 client_batch=CLIENT_BATCH, labeled_batch=64,
                 queue_len=QUEUE, k_s=5, k_u=4, eval_every=1, device="cuda")

# The teacher is an EMA (decay 0.99) of the student and clears tau = 0.95
# only after some tens of rounds from random weights; until then no anchor
# is confident and the clustering kernels have nothing to sum.  The int8
# run trains long enough for part of the batch to become confident.
MAIN_RUNS = (("int8+topk0.05", 150), ("fp32", 1))


# paper-vgg13's cut (12 x 12 x 512 a sample, 9.4 MB a client) is beyond a
# cluster, so its rounds put the quantizer's two-pass route on a path: 3
# int8 rounds at full width, with the main path's clients and batches
VGG_RUN = ("paper-vgg13", "int8", 3)


def _train(card: str, arch: str, wire: str, rounds: int, note: str = "",
           **kw):
    """One training run through the entry point (``kw`` goes to it; ``note``
    goes on its printed lines); returns (state, system, rounds with a
    confident anchor)."""
    from repro_torch.launch.train import run_training
    t0 = time.time()
    state, history, system = run_training(arch, rounds=rounds,
                                          wire_format=wire,
                                          log=lambda _: None, **MAIN_PATH,
                                          **kw)
    confident = [rec["round"] for rec in history if rec["mask_rate"] < 1.0]
    note = f" ({note})" if note else ""
    print(f"[main] {arch} wire={wire}{note}, per round: f_s f_u mask_rate "
          f"K_s teacher_acc wall_s")
    for rec in history:
        if not all(np.isfinite([rec["f_s"], rec["f_u"], rec["test_acc"]])):
            fail(f"non-finite metrics in {rec}")
        print(f"[main] {rec['round']:3d} {rec['f_s']:.6g} "
              f"{rec['f_u']:.6g} {rec['mask_rate']:.4g} {rec['k_s']} "
              f"{rec['test_acc']:.4g} {rec['dt']:.3f}")
    print(f"[main] {arch} wire={wire}{note}: {rounds} rounds in "
          f"{time.time() - t0:.2f} s (incl. data and set-up) on {card}; "
          f"{len(confident)} rounds with mask_rate < 1, the first "
          f"{confident[0] if confident else None}")
    return state, system, confident


def phase_main_path(card: str) -> dict:
    """Returns {wire: (state, system)} of each run."""
    runs, live = {}, 0
    for wire, rounds in MAIN_RUNS:
        state, system, confident = _train(card, "paper-cnn", wire, rounds)
        live += len(confident)
        runs[wire] = (state, system)
    if not live:
        fail("no main-path round had a confident anchor (mask_rate < 1): "
             "the clustering kernels did no work")
    return runs


def phase_vgg(card: str) -> dict:
    """The paper-vgg13 rounds, with the launch counts set to 0 just before
    and read just after; its cut must take the two-pass route."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    arch, wire, rounds = VGG_RUN
    reset_launch_counts()
    _train(card, arch, wire, rounds)
    counts = launch_counts()
    print(f"[main] kernel launches on the {arch} path: {counts}")
    if not (counts["quantize_amax"] and counts["quantize_qdq"]
            and counts["quantize_fused"] == 0):
        fail(f"the {arch} path must take the quantizer's two-pass route, "
             f"launched {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU, one cross-entity step
# ---------------------------------------------------------------------------

def _to_cpu(tree):
    import torch

    from repro_torch.tree import tree_map
    return tree_map(
        lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, tree)


def _sharpened(model: dict, factor: float) -> dict:
    """``model`` with its classifier weights scaled by ``factor``."""
    cls = model["top"]["cls"]
    return dict(model, top=dict(model["top"], cls={"w": cls["w"] * factor,
                                                   "b": cls["b"]}))


# classifier scales tried in turn until a step on the card has a partly
# confident batch (a model from a few rounds of random weights clears tau
# = 0.95 nowhere; one scaled too far clears it everywhere)
SHARPEN_FACTORS = (40.0, 20.0, 80.0, 10.0, 160.0, 5.0, 320.0, 2.5)


def _images(seed: int, n: int, b: int, hw: int):
    import torch

    from repro_torch.data.synthetic import make_image_dataset
    ds = make_image_dataset(seed, n=n * b, image_size=hw)
    return (torch.from_numpy(ds.x.reshape(n, b, hw, hw, 3)),
            torch.from_numpy(ds.y.reshape(n, b)))


def _max_err(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def cross_step(state, system, batch: int = CLIENT_BATCH,
               ulp_spread: bool = False) -> dict:
    """One semi step from the same state and draws on the card and through
    the port on the CPU, for ``system``'s clients and ``batch`` of its
    config's images a client, the teacher's classifier sharpened by the
    first of SHARPEN_FACTORS that gives a partly confident batch.  Returns
    the two sides' (loss, h, mask_rate), the largest errors (losses;
    parameters and queue features, with the worst leaf's name), the queue
    labels' agreement and, with ``ulp_spread``, how far 1 ulp either way
    on every float of the state moves the CPU's own step (read only)."""
    import torch

    from repro_torch.core.engine import SemiCarry, SemiSFLSystem
    from repro_torch.tree import tree_leaves, tree_map

    n, b = system.n_active, batch
    bottoms, t_bottoms = system.broadcast(state)
    xu, _ = _images(5, n, b, system.cfg.image_size)
    draws = system.sampler.semi(n, b)
    # from a few rounds of random weights the teacher does not clear tau;
    # sharpen its classifier so that part of the batch is confident and
    # the clustering loss has anchors (the same state goes to both sides)
    for factor in SHARPEN_FACTORS:
        carry = SemiCarry(bottoms=bottoms, teacher_bottoms=t_bottoms,
                          top=state.params["top"], proj=state.params["proj"],
                          teacher=_sharpened(state.teacher, factor),
                          queue=state.queue, step=state.step)
        new_g, out_g = system.semi_step(carry, xu.to(system.device), draws)
        if 0.0 < float(out_g[2]) < 1.0:
            break
    else:
        fail(f"cross-check: no classifier scale of {SHARPEN_FACTORS} "
             f"gives a partly confident batch")
    cpu = SemiSFLSystem(system.cfg, n_clients_per_round=n,
                        wire_format=system.wire,
                        use_clustering=system.use_clustering,
                        use_supcon=system.use_supcon, device="cpu")
    carry_c, draws_c = _to_cpu(carry), _to_cpu(draws)
    new_c, out_c = cpu.semi_step(carry_c, xu, draws_c)
    new_g = _to_cpu(new_g)
    out_g, out_c = [float(v) for v in out_g], [float(v) for v in out_c]
    qg, qc = new_g.queue, new_c.queue
    names = [f"{field}[{i}]" for field, tree in zip(SemiCarry._fields[:5],
                                                     new_g[:5])
             for i in range(len(tree_leaves(tree)))] + ["queue.z"]
    pairs = list(zip(tree_leaves(new_g[:5]) + [qg.z],
                     tree_leaves(new_c[:5]) + [qc.z]))
    errs = [float((a - b_).abs().max()) for a, b_ in pairs]
    worst = int(np.argmax(errs))
    # the losses read a queue label only where its entry is confident and
    # valid (SupCon's and Eq. (5)'s positives); an unconfident sample's
    # argmax may sit on a near-tie that the two sides' rounding decides
    read = qg.conf & qg.valid
    out = dict(factor=factor, out_g=out_g, out_c=out_c,
               lerr=max(abs(a - b_) for a, b_ in zip(out_g, out_c)),
               err=errs[worst], worst=(names[worst],
                                       tuple(pairs[worst][0].shape)),
               same_q=(torch.equal(qg.conf, qc.conf)
                       and torch.equal(qg.valid, qc.valid)
                       and torch.equal(qg.label[read], qc.label[read])),
               unread=int((qg.label[~read] != qc.label[~read]).sum()),
               close=all(torch.allclose(a, b_, atol=1e-3, rtol=1e-3)
                         for a, b_ in pairs),
               new=new_g, carry=carry)
    if ulp_spread:
        spread = 0.0
        for sign in (1, -1):
            nudged = tree_map(
                lambda t: (t * (1 + sign * 2.0 ** -23)
                           if t.is_floating_point() else t), carry_c[:5])
            moved, _ = cpu.semi_step(carry_c._replace(
                **dict(zip(SemiCarry._fields[:5], nudged))), xu, draws_c)
            spread = max(spread, _max_err(zip(
                tree_leaves(new_c[:5]) + [qc.z],
                tree_leaves(moved[:5]) + [moved.queue.z])))
        out["ulp_spread"] = spread
    return out


def phase_cross_check(state, system, batch: int = CLIENT_BATCH,
                      what: str = "semi step", unread_flips: int = 0,
                      ulp_spread: bool = False):
    """:func:`cross_step`, held: cuDNN and the CPU pick other convolution
    algorithms and the kernels sum in another order, so the tolerance is
    1e-3; at most ``unread_flips`` queue labels that no loss reads may
    differ.  With ``ulp_spread`` it also prints the CPU's own spread under
    1 ulp of the state, which the check does not read."""
    r = cross_step(state, system, batch, ulp_spread)
    n = system.n_active
    print(f"[cross] {what} card vs CPU ({n} clients of {batch}, classifier "
          f"x{r['factor']:g}): (loss, h, mask_rate) {r['out_g']} vs "
          f"{r['out_c']}; max|err| losses {r['lerr']:.3g}, parameters and "
          f"queue features {r['err']:.3g} (worst leaf {r['worst'][0]} "
          f"{r['worst'][1]})"
          + (f", the CPU's own spread under 1 ulp of the state "
             f"{r['ulp_spread']:.3g} (read, not held)" if ulp_spread else "")
          + f"; confidence mask and the labels it lets the losses read "
          f"equal: {r['same_q']} (unconfident labels, read by no loss, "
          f"differing: {r['unread']})")
    if not (r["lerr"] <= 1e-3 and r["same_q"] and r["unread"] <= unread_flips
            and r["close"]):
        fail(f"the card and the CPU disagree on one {what}")
    return r["new"], r["carry"]


# ---------------------------------------------------------------------------
# phase 6: where one round's time goes
# ---------------------------------------------------------------------------

OUR_KERNELS = ("clustering_fwd_partial", "clustering_fwd_merge",
               "clustering_bwd_partial", "clustering_bwd_merge",
               "quantize_fused_kernel", "amax_kernel", "qdq_kernel")
# the kernels the profiled round must show, and the quantizer's
ROUND_KERNELS = ("clustering_fwd_partial", "clustering_fwd_merge",
                 "clustering_bwd_partial", "clustering_bwd_merge",
                 "quantize_fused_kernel")
QUANT_KERNELS = ("quantize_fused_kernel", "amax_kernel", "qdq_kernel")


def phase_profile(card: str, trained) -> None:
    """Warm int8+topk0.05 rounds of the main path, going on from the
    ``trained`` state of its int8 run, so that part of each batch is
    confident and the clustering kernels do their work: three rounds' wall
    time on the host clock (each ending in a synchronize), then one more
    round under ``torch.profiler`` for device busy time, kernel time by
    name and the host time of the round's three phase spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_run
    kw = {k: v for k, v in MAIN_PATH.items() if k != "eval_every"}
    run = build_run("paper-cnn", wire_format="int8+topk0.05", **kw)
    masks = []

    def one(state):
        state, m = run.system.run_round(state, run.labeled, run.clients,
                                        run.controller,
                                        rng_np=run.select_rng)
        torch.cuda.synchronize()
        masks.append(m.mask_rate)
        return state

    state = one(one(trained))                        # warm-up
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = one(state)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = one(state)
        wall_prof = time.perf_counter() - t0
    print(f"[profile] mask_rate of the 2 warm-up, 3 timed and 1 profiled "
          f"rounds: {', '.join(f'{m:.4f}' for m in masks)}")
    if masks[-1] >= 1.0:
        fail("the profiled round had no confident anchor")
    # device-side entries only: kernels and copies (the spans' device-side
    # mirrors cover whole phases and would count every kernel twice)
    device = [op for op in _device_ops(prof)
              if not op[0].startswith("semisfl.")]
    kernels = _by_name(device)
    busy = _busy_s(device)
    ours = _ours(kernels, OUR_KERNELS)
    print(f"[profile] round wall (no profiler) "
          f"{', '.join(f'{w:.6f}' for w in walls)} s; under the profiler "
          f"{wall_prof:.6f} s, device busy {busy:.6f} s (idle share "
          f"{1 - busy / wall_prof:.4f}); the ported kernels "
          f"{sum(t for t, _ in ours.values()):.6f} s ("
          f"{', '.join(f'{k} {t:.6f} x{n}' for k, (t, n) in ours.items())}"
          f"); {len(device)} device ops; on {card}")
    quant = [ours[k] for k in QUANT_KERNELS]
    print(f"[profile] the quantizer a round: "
          f"{sum(t for t, _ in quant) * 1e3:.4f} ms of device time in "
          f"{sum(n for _, n in quant)} launches on {card}")
    unseen = [k for k in ROUND_KERNELS if ours[k][1] == 0]
    if unseen:
        fail(f"the profiled round shows no launch of {unseen}")
    for name, host_s in _host_spans(prof, "semisfl.").items():
        print(f"[profile] span {name}: host {host_s * 1e3:.3f} ms")
    for name, t, n in kernels[:12]:
        print(f"[profile] device {t * 1e3:9.3f} ms x{n:<5d} {name[:100]}")


# ---------------------------------------------------------------------------
# phases 6a-6d: the baselines, the paper's other models, checkpoints
# ---------------------------------------------------------------------------

BASELINE_ROUNDS = 5
# each method's run: the four full-model baselines with no wire, and the
# FedSwitch-SL ablation (SemiSFL without clustering and SupCon) on the
# main path's wire
SPLIT_RUNS = {"fedswitch-sl": "int8+topk0.05"}
CLUSTER_LAUNCHES = ("clustering_fwd", "clustering_bwd")
# a local loss above this is more than FedMatch's L1 term on psi (1e-11
# to 1e-5 a round): some pseudo-label cleared tau
LIVE_LOSS = 1e-3


def _trained_start(method: str, trained):
    """``method``'s first state, holding phase 4's 150-round paper-cnn
    model, whose pseudo-labels clear tau = 0.95 on part of each batch (from
    random weights none does within 5 rounds, and every local loss is 0).
    FedSwitch-SL goes on from the trained SemiSFL state; a full-model
    baseline takes its student and teacher (FedMatch as sigma, psi 0) with
    fresh momentum."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_system
    from repro_torch.tree import tree_map
    if method in SPLIT_RUNS:
        return trained
    fresh = build_system(method, get_config("paper-cnn"),
                         device=MAIN_PATH["device"]).init_state(0)
    model = lambda p: tree_map(torch.clone, {k: p[k] for k in ("bottom",
                                                               "top")})
    params, teacher = model(trained.params), model(trained.teacher)
    if "sigma" in fresh.params:
        params = dict(fresh.params, sigma=params)
        teacher = dict(fresh.teacher, sigma=teacher)
    return fresh._replace(params=params, teacher=teacher)


def _bill(system, state, method: str, wire, history: list):
    """The cost model's bill of a run (``core/commcost.py``: bytes from its
    trees and cut at their wire formats, seconds from the paper's link
    model, not from the card), round by round at the K_s each ran with."""
    from repro_torch.core.commcost import CostModel, round_bill, tree_bytes
    from repro_torch.core.wire import parse_wire_format
    params = state.params
    if "bottom" in params:
        bottom = tree_bytes(params["bottom"])
        full = tree_bytes({k: params[k] for k in ("bottom", "top")})
    else:
        bottom = full = tree_bytes(params)
    hw, c = system.model.feat_shape(system.model.split)
    cost, k_s, bills = CostModel(seed=0), MAIN_PATH["k_s"], []
    for rec in history:
        bills.append(round_bill(
            method, system.cfg, bottom_bytes=bottom, full_bytes=full,
            feat_bytes_per_batch=CLIENT_BATCH * hw * hw * c * 4, k_s=k_s,
            k_u=MAIN_PATH["k_u"], n_active=N_ACTIVE, batch=CLIENT_BATCH,
            cost=cost, wire=parse_wire_format(wire)))
        k_s = rec["k_s"]
    return bills


def phase_baselines(card: str, trained) -> dict:
    """Each baseline through the launcher at paper-cnn's full config with
    the main path's clients and batches, from phase 4's ``trained`` model,
    the launch counts set to 0 just before each run and read just after:
    FedSwitch-SL must launch the fused quantizer and no clustering kernel,
    the full-model baselines no ported kernel; every method but
    Supervised-only must have a live local loss in its first round (later
    ones are counted: a method may drift to where no pseudo-label clears
    tau).  Returns {method: (final state, system, first state)}."""
    import torch

    from repro_torch.core.baselines import BASELINES
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import run_training
    runs = {}
    for method in list(BASELINES) + list(SPLIT_RUNS):
        wire = SPLIT_RUNS.get(method)
        start = _trained_start(method, trained)
        reset_launch_counts()
        t0 = time.time()
        state, history, system = run_training(
            "paper-cnn", rounds=BASELINE_ROUNDS, baseline=method,
            state=start, wire_format=wire, log=lambda _: None, **MAIN_PATH)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
        keys = [k for k in history[0] if k != "round"]
        print(f"[baselines] {method} wire={wire}, per round: "
              + " ".join(keys))
        for rec in history:
            vals = [rec[k] for k in keys]
            if not all(np.isfinite(vals)):
                fail(f"{method}: non-finite metrics in {rec}")

            print(f"[baselines] {rec['round']:3d} "
                  + " ".join(f"{v:.6g}" for v in vals))
        live = sum(rec["f_u"] > LIVE_LOSS for rec in history)
        if method != "supervised-only" and not history[0]["f_u"] > LIVE_LOSS:
            fail(f"{method}: no pseudo-label cleared tau in the first round "
                 f"from the trained model: {history[0]}")
        launched = {k: v for k, v in counts.items() if v}
        print(f"[baselines] {method} wire={wire}: {BASELINE_ROUNDS} rounds "
              f"in {wall:.2f} s (incl. data and set-up) on {card}; {live} "
              f"with a live local loss; kernel launches "
              f"{launched or 'none'}")
        bills = _bill(system, state, method, wire, history)
        print(f"[baselines] {method} wire={wire}: cost model a round (bytes "
              f"up, bytes down, seconds; the paper's link and FLOP rates, "
              f"not the card): "
              + "; ".join(f"{b.bytes_up:.0f}, {b.bytes_down:.0f}, "
                          f"{b.seconds:.4f}" for b in bills))
        if method in SPLIT_RUNS:
            if not counts["quantize_fused"] or any(
                    counts[k] for k in CLUSTER_LAUNCHES):
                fail(f"{method} must launch the fused quantizer and no "
                     f"clustering kernel, launched {launched}")
        elif launched:
            fail(f"the full-model baseline {method} launched {launched}")
        runs[method] = (state, system, start)
    return runs


def _fl_sharpened(params: dict, factor: float) -> dict:
    if "sigma" in params:                    # FedMatch: sigma + psi
        return dict(params, sigma=_sharpened(params["sigma"], factor))
    return _sharpened(params, factor)


def _check_pair(what: str, got, want, loss_g, loss_c) -> None:
    import torch

    from repro_torch.tree import tree_leaves
    pairs = list(zip(tree_leaves(_to_cpu(got)), tree_leaves(want)))
    err, lerr = _max_err(pairs), abs(float(loss_g) - float(loss_c))
    print(f"[cross] {what} card vs CPU: loss {float(loss_g):.6g} vs "
          f"{float(loss_c):.6g}; max|err| loss {lerr:.3g}, parameters "
          f"{err:.3g}")
    if not (lerr <= 1e-3 and all(torch.allclose(a, b, atol=1e-3, rtol=1e-3)
                                 for a, b in pairs)):
        fail(f"the card and the CPU disagree on {what}")


# classifier scales tried in turn, smallest first, until a full-model
# baseline's local loss is live: only the pseudo-labeller is scaled (the
# global model for SemiFL, the teacher for FedSwitch, each client's own
# model for FedMatch), so that the student's gradients stay those of the
# trained model
LABELLER_FACTORS = (1.0, 2.5, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 320.0)
# a student scaled with its labeller makes the local step ill-conditioned:
# a ReLU or max-pool choice that a rounding decides moves its large
# gradient, so that a change of 1 ulp in the student, or another
# convolution algorithm, moves the result by up to 2e-3.  That input is
# read (``_scaled_student_readout``), not held to 1e-3
STUDENT_FACTOR = 40.0
# FedMatch's psi can drift within its 5 rounds to where no pseudo-label
# clears tau at any classifier scale (whether the JAX package drifts alike
# is open, ROADMAP Queue 3), so its local step is also checked from the
# run's first state, which phase 6a requires live in its first round: that
# check is held, the final state's where some scale makes it live
DRIFTING = ("fedmatch",)


def _scaled(method: str, state, factor: float, student: bool = False):
    """(client params stacked N times, teacher, global model) of a local
    step with the labeller's classifier, and the student's if
    ``student``, scaled by ``factor``."""
    from repro_torch.tree import tree_map
    sharp = _fl_sharpened(state.params, factor)
    stack = lambda t: t.expand((N_ACTIVE,) + t.shape).clone()
    cp = tree_map(stack, sharp if student or method == "fedmatch"
                  else state.params)
    return cp, _fl_sharpened(state.teacher, factor), sharp


def _cpu_local(cpu, args, xu, draws):
    """The local step from ``args`` through the port on the CPU, and how
    far a change of 1 ulp either way in the client params moves its
    parameters (the step's own conditioning)."""
    from repro_torch.tree import tree_leaves, tree_map
    args, draws = [_to_cpu(a) for a in args], _to_cpu(draws)
    new, loss = cpu.local_step(*args, xu, draws)
    shift = 0.0
    for sign in (1, -1):
        nudged = tree_map(lambda t: t * (1 + sign * 2.0 ** -23), args[0])
        moved, _ = cpu.local_step(nudged, *args[1:], xu, draws)
        shift = max(shift, _max_err(zip(tree_leaves(new),
                                        tree_leaves(moved))))
    return new, loss, shift


def _scaled_student_readout() -> None:
    """SemiFL's local step with the student scaled with its labeller
    (x``STUDENT_FACTOR``), from 5 rounds of the seeded init and with the
    draws taken as the cross-check takes them: the card against the CPU,
    the card with cuDNN off (PyTorch's own fp32 convolutions) against
    both, and the CPU's shift under 1 ulp.  Read, not held."""
    import torch

    from repro_torch.launch.train import run_training
    from repro_torch.tree import tree_leaves
    state, _, system = run_training(
        "paper-cnn", rounds=BASELINE_ROUNDS, baseline="semifl",
        log=lambda _: None, **MAIN_PATH)
    xu, _ = _images(5, N_ACTIVE, CLIENT_BATCH, system.cfg.image_size)
    system.sampler.supervised(MAIN_PATH["labeled_batch"])
    loc = system.sampler.local(N_ACTIVE, CLIENT_BATCH)
    args = _scaled("semifl", state, STUDENT_FACTOR, student=True)
    new_g, loss_g = system.local_step(*args, xu.to(system.device), loc)
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        new_n, _ = system.local_step(*args, xu.to(system.device), loc)
    cpu = type(system)(system.cfg, n_clients_per_round=N_ACTIVE,
                       device="cpu")
    new_c, loss_c, shift = _cpu_local(cpu, args, xu, loc)
    err = lambda a, b: _max_err(zip(tree_leaves(_to_cpu(a)),
                                    tree_leaves(_to_cpu(b))))
    print(f"[cross] semifl local step after 5 rounds from the seeded init, "
          f"student and labeller x{STUDENT_FACTOR:g}, read and not held: "
          f"loss {float(loss_g):.6g} vs {float(loss_c):.6g}; max|err| "
          f"parameters card vs CPU {err(new_g, new_c):.3g}, card with "
          f"cuDNN off vs CPU {err(new_n, new_c):.3g} and vs cuDNN "
          f"{err(new_n, new_g):.3g}; 1 ulp in the student moves the CPU's "
          f"result {shift:.3g}")
    if not np.isfinite([float(loss_g), err(new_g, new_c)]).all():
        fail("non-finite SemiFL local step at a scaled student")


def _cross_local(method: str, state, system, cpu, xu, loc,
                 where: str) -> bool:
    """``method``'s local step from ``state`` and the draws ``loc`` on the
    card and on the CPU, at the first of LABELLER_FACTORS that gives a live
    local loss on the card, held to 1e-3; False, and nothing compared, where
    none does."""
    for factor in LABELLER_FACTORS:
        args = _scaled(method, state, factor)
        new_g, loss_g = system.local_step(*args, xu.to(system.device), loc)
        if method == "supervised-only" or float(loss_g) > LIVE_LOSS:
            break
    else:
        return False
    new_c, loss_c, shift = _cpu_local(cpu, args, xu, loc)
    _check_pair(f"{method} local step from its {where} (labeller's "
                f"classifier x{factor:g}; 1 ulp in the student moves the "
                f"CPU's result {shift:.3g})", new_g, new_c, loss_g, loss_c)
    return True


def phase_baseline_cross_check(runs: dict) -> None:
    """For each full-model baseline, one supervised step and one local step
    from its trained state and the same draws on the card and through the
    port on the CPU, with the local step's conditioning beside it; for
    FedSwitch-SL one semi step, whose projection head must come out
    unchanged; then the readout at a scaled student."""
    import torch

    from repro_torch.core.baselines import BASELINES
    from repro_torch.tree import tree_leaves
    for method, (state, system, start) in runs.items():
        hw = system.cfg.image_size
        xu, _ = _images(5, N_ACTIVE, CLIENT_BATCH, hw)
        xl, yl = _images(6, 1, MAIN_PATH["labeled_batch"], hw)
        xl, yl = xl[0], yl[0]
        if method not in BASELINES:
            new_g, carry = phase_cross_check(state, system,
                                             what=f"{method} semi step")
            if not all(torch.equal(a, b.cpu()) for a, b in zip(
                    tree_leaves(new_g.proj), tree_leaves(carry.proj))):
                fail(f"{method}: the semi step moved the projection head")
            continue
        cpu = type(system)(system.cfg, n_clients_per_round=N_ACTIVE,
                           device="cpu")
        sup = system.sampler.supervised(len(yl))
        loc = system.sampler.local(N_ACTIVE, CLIENT_BATCH)
        live = _cross_local(method, state, system, cpu, xu, loc,
                            "final state")
        if method in DRIFTING:
            if not live:
                print(f"[cross] {method}: its final state has drifted to "
                      f"where no classifier scale of {LABELLER_FACTORS} "
                      f"gives a live local loss (ROADMAP Queue 3)")
            live = _cross_local(method, start, system, cpu, xu, loc,
                                "first state")
        if not live:
            fail(f"{method}: no classifier scale gives a live local loss")
        sg, lg = system.supervised_step(
            state, (xl.to(system.device), yl.to(system.device)), sup)
        sc, lc = cpu.supervised_step(_to_cpu(state), (xl, yl), _to_cpu(sup))
        _check_pair(f"{method} supervised step", sg[:3], sc[:3], lg, lc)
    _scaled_student_readout()


# the paper's other two models, 3 int8 SemiSFL rounds each at full width
# with the main path's clients and batches: AlexNet's cut (4 x 4 x 256 a
# sample, 512 KiB a client) fits a cluster and takes the quantizer's fused
# route; VGG16's (18 x 18 x 512, 20.25 MiB a client) takes the two-pass
# one.  VGG16 (no normalization layers) diverges at the default rate 0.02
# from its random init, in the JAX package as in the port (ROADMAP Queue
# 3), so its rounds run at 0.002
MODEL_RUNS = (("paper-alexnet", "int8", 3, "fused", 0.02),
              ("paper-vgg16", "int8", 3, "two_pass", 0.002))
# queue labels that no loss reads and that may differ card against CPU:
# VGG16's 100 classes and 2e-4 feature error (FFT convolutions) put an
# unconfident argmax on a near-tie now and then
UNREAD_FLIPS = {"paper-vgg16": 1}


def _check_route(arch: str, route: str, counts: dict) -> None:
    fused = counts["quantize_fused"]
    two = counts["quantize_amax"] and counts["quantize_qdq"]
    if route == "fused" and not (fused and not counts["quantize_amax"]
                                 and not counts["quantize_qdq"]):
        fail(f"the {arch} path must take the quantizer's fused route, "
             f"launched {counts}")
    if route == "two_pass" and not (two and not fused):
        fail(f"the {arch} path must take the quantizer's two-pass route, "
             f"launched {counts}")


def _profile_round(card: str, arch: str, wire: str, lr: float,
                   trained, system) -> None:
    """One more round of the run's ``system`` going on from its
    ``trained`` state under ``torch.profiler`` (a warm round: the system's
    graphs are captured), on fresh loaders: wall, device busy time and
    idle share, the ported kernels' device time a launch, and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_run
    kw = {k: v for k, v in MAIN_PATH.items() if k != "eval_every"}
    run = build_run(arch, wire_format=wire, lr=lr, **kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = system.run_round(trained, run.labeled, run.clients,
                                run.controller, rng_np=run.select_rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [op for op in _device_ops(prof)
              if not op[0].startswith("semisfl.")]
    kernels = _by_name(device)
    busy = _busy_s(device)
    ours = ", ".join(f"{k} {t * 1e3:.4f} ms x{n}" for k, (t, n)
                     in _ours(kernels, OUR_KERNELS).items())
    if not np.isfinite([m.f_s, m.f_u]).all():
        fail(f"{arch}: non-finite metrics in the profiled round: {m}")
    print(f"[profile] {arch} wire={wire} round under the profiler: wall "
          f"{wall:.6f} s, device busy {busy:.6f} s (idle share "
          f"{1 - busy / wall:.4f}), {len(device)} device ops; the ported "
          f"kernels: {ours}; on {card}")
    for name, t, n in kernels[:8]:
        print(f"[profile] {arch} device {t * 1e3:9.3f} ms x{n:<5d} "
              f"{name[:100]}")


def phase_models(card: str) -> dict:
    """The paper-alexnet and paper-vgg16 rounds on cuDNN's default
    algorithms, as the trainer runs them, each with its launch counts set
    to 0 just before and read just after, its route checked, its peak
    device memory and one profiled round, then its peak device memory
    through the eager executor (``scan_rounds=False``) over one round.
    Then the same
    rounds again through the eager executor on
    cuDNN's deterministic algorithms, and from that state a card-against-CPU
    semi step at full widths and image size with 2 clients of 8 samples,
    the CPU's own spread under 1 ulp of the state beside it (read, not
    held).  Only the checked state is made that way: under the default
    algorithms VGG16's trained state differed from run to run (its
    parameters 1.2e-3 to 2.1e-3 apart after 3 rounds), and the step's error
    with it (7.8e-5 to 2.5e-4 in 5 runs, 2.38e-3 once), where from one state
    the step repeats its error (``scripts/vgg16_cross_study.py``).  Returns
    each run's launch counts by arch."""
    import torch

    from repro_torch.core.engine import SemiSFLSystem
    from repro_torch.kernels import launch_counts, reset_launch_counts
    out = {}
    for arch, wire, rounds, route, lr in MODEL_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state, system, _ = _train(card, arch, wire, rounds, lr=lr)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"[main] kernel launches on the {arch} path: {counts}")
        print(f"[main] {arch} peak device memory "
              f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated) "
              f"on {card}")
        _check_route(arch, route, counts)
        _profile_round(card, arch, wire, lr, state, system)
        out[arch] = counts
        del state, system
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # one round: each round of the eager executor allocates alike, so
        # its first holds the peak
        state, system, _ = _train(card, arch, wire, 1,
                                  note="the eager executor, its peak", lr=lr,
                                  scan_rounds=False)
        print(f"[main] {arch} peak device memory through the eager "
              f"executor {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
              f" GiB, {peak / 2 ** 30:.3f} GiB through the graphs, on "
              f"{card}")
        del state, system
        torch.cuda.empty_cache()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            state, system, _ = _train(
                card, arch, wire, rounds, note="cuDNN's deterministic "
                "algorithms, the eager executor, the cross-check's state",
                lr=lr, scan_rounds=False)
            small = SemiSFLSystem(system.cfg, n_clients_per_round=2,
                                  wire_format=wire, device=system.device)
            phase_cross_check(state, small, batch=8,
                              what=f"{arch} semi step",
                              unread_flips=UNREAD_FLIPS.get(arch, 0),
                              ulp_spread=True)
        del state, system, small
    return out


def phase_checkpoints(card: str) -> None:
    """Each method once through the launcher's CLI at paper-cnn's full
    config (``--baseline B --full-config --rounds 2 --ckpt``); the
    checkpoint restores into a fresh system's template bit for bit, and
    the restored model's test accuracy equals the trained one's."""
    import torch

    from repro_torch.checkpoint.io import restore_state
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.launch.train import SPLIT_BASELINES, build_system, main
    from repro_torch.core.baselines import BASELINES
    from repro_torch.tree import tree_leaves
    test = make_image_dataset(7, n=400, image_size=32)
    out = ROOT / "build" / "chip_smoke_ckpt"
    for method in list(SPLIT_BASELINES) + list(BASELINES):
        path = str(out / method)
        t0 = time.time()
        state, history, system = main(
            ["--baseline", method, "--full-config", "--rounds", "2",
             "--ckpt", path, "--device", MAIN_PATH["device"]])
        wall = time.time() - t0
        fresh = build_system(method, system.cfg, device=system.device,
                             n_clients_per_round=system.n_active)
        restored, meta = restore_state(path, fresh.init_state(1).params)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(restored), tree_leaves(state.params)))
        if method in SPLIT_BASELINES:
            # the engine evaluates the teacher: put the params there
            before = system.evaluate(state._replace(teacher=state.params),
                                     test.x, test.y)
            after = fresh.evaluate(state._replace(teacher=restored),
                                   test.x, test.y)
        else:
            before = system.evaluate(state, test.x, test.y,
                                     use_teacher=False)
            after = fresh.evaluate(state._replace(params=restored), test.x,
                                   test.y, use_teacher=False)
        print(f"[ckpt] {method}: 2 rounds through the CLI in {wall:.2f} s "
              f"on {card}; {len(tree_leaves(restored))} arrays restored, "
              f"equal: {same}; accuracy {before:.4f} before, {after:.4f} "
              f"after; meta {sorted(meta)} baseline {meta['baseline']}")
        if not (same and before == after and meta["baseline"] == method
                and len(meta["history"]) == len(history) == 2):
            fail(f"{method}: the checkpoint does not round-trip")


# ---------------------------------------------------------------------------
# phase 6e: the scanned executor (CUDA graphs) against the eager one
# ---------------------------------------------------------------------------

# (K_s, K_u): the main path's, and the published configuration's
# (src/repro/configs/base.py:87-88)
EXEC_KS = ((MAIN_PATH["k_s"], MAIN_PATH["k_u"]), (100, 10))
EXEC_WARM = 3                     # timed warm rounds of each executor
# name: (scan_rounds, prefetch); the eager one is what the others are held
# to
EXECUTORS = {"graph": (True, False), "eager": (False, False),
             "graph+prefetch": (True, True)}


def _exec_rounds(trained, k_s: int, k_u: int, scan_rounds: bool,
                 prefetch: bool) -> dict:
    """1 + EXEC_WARM + 1 int8+topk0.05 rounds of the main path going on
    from ``trained`` through one executor: the first (for the graph
    executor, its warm-up and capture), EXEC_WARM timed on the host clock
    with the launch counts set to 0 just before and read just after, and
    one under ``torch.profiler``; the peak device memory over all of
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import build_run
    kw = {k: v for k, v in MAIN_PATH.items()
          if k not in ("eval_every", "k_s", "k_u")}
    run = build_run("paper-cnn", wire_format="int8+topk0.05", k_s=k_s,
                    k_u=k_u, scan_rounds=scan_rounds, prefetch=prefetch,
                    **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = []

    def one(state):
        t0 = time.perf_counter()
        state, m = run.system.run_round(state, run.labeled, run.clients,
                                        run.controller,
                                        rng_np=run.select_rng)
        torch.cuda.synchronize()
        metrics.append((m.f_s, m.f_u, m.mask_rate, m.k_s))
        return state, time.perf_counter() - t0

    state, first = one(trained)
    reset_launch_counts()
    walls = []
    for _ in range(EXEC_WARM):
        state, wall = one(state)
        walls.append(wall)
    counts = {k: v / EXEC_WARM for k, v in launch_counts().items() if v}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, wall_prof = one(state)
    peak = torch.cuda.max_memory_allocated()
    device = [op for op in _device_ops(prof)
              if not op[0].startswith("semisfl.")]
    kernels = _by_name(device)
    graphs = [g for phase in (run.system.supervised_phase,
                              run.system.semi_phase)
              for g in phase.graphs.values()]
    stats = run.system.prefetch_stats()
    run.system.close()
    return dict(state=state, metrics=metrics, first=first, walls=walls,
                prefetch=stats,
                counts=counts, wall_prof=wall_prof,
                busy=_busy_s(device), n_ops=len(device),
                ours=_ours(kernels, ROUND_KERNELS), peak=peak,
                capture_s=sum(g.capture_s for g in graphs),
                n_graphs=len(graphs))


def _state_diff(a, b) -> float:
    """The largest |a - b| over every leaf of two states (a host leaf
    counts 1 where it differs)."""
    import torch

    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    return max(float((x.double() - y.double()).abs().max())
               if isinstance(x, torch.Tensor) else float(x != y)
               for x, y in zip(la, lb))


def phase_executors(card: str, trained) -> None:
    """The main path's rounds through both executors, from phase 4's
    ``trained`` state with the same data and draws, on cuDNN's
    deterministic algorithms with no TF32, at each (K_s, K_u) of EXEC_KS:
    the graph executor's states (parameters, teacher, momentum, queue,
    step) and metrics must equal the eager one's bit for bit after every
    round run, and each ported kernel's launches a warm round must be the
    same.  Prints each executor's warm round walls, its profiled round's
    device busy time, idle share and device op count, its launches a
    round, its peak device memory and the graph executor's one-off
    warm-up and capture.  The graph executor fed by the prefetch worker
    (its stacks copied on a side stream) is held to the eager one too."""
    import torch
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for k_s, k_u in EXEC_KS:
            res = {name: _exec_rounds(trained, k_s, k_u, *opts)
                   for name, opts in EXECUTORS.items()}
            for name, r in res.items():
                walls = r["walls"]
                print(f"[executors] K_s {k_s} K_u {k_u} {name}: warm round "
                      f"wall {', '.join(f'{w:.6f}' for w in walls)} s "
                      f"(mean {np.mean(walls):.6f}), first round "
                      f"{r['first']:.6f} s; profiled round {r['wall_prof']:.6f}"
                      f" s, device busy {r['busy']:.6f} s (idle share "
                      f"{1 - r['busy'] / r['wall_prof']:.4f}), {r['n_ops']} "
                      f"device ops; peak device memory "
                      f"{r['peak'] / 2 ** 30:.3f} GiB; warm-up and capture "
                      f"{r['capture_s']:.4f} s of host time in "
                      f"{r['n_graphs']} graphs; on {card}")
                print(f"[executors] K_s {k_s} K_u {k_u} {name}: launches a "
                      f"round {r['counts']}; the profiled round's ported "
                      f"kernels "
                      + ", ".join(f"{k} {t * 1e3:.4f} ms x{n}"
                                  for k, (t, n) in r["ours"].items())
                      + (f"; prefetch {r['prefetch']}" if r["prefetch"]
                         else ""))
            e = res["eager"]
            for name in ("graph", "graph+prefetch"):
                g = res[name]
                diff = _state_diff(g["state"], e["state"])
                print(f"[executors] K_s {k_s} K_u {k_u}: {name} against "
                      f"eager after {1 + EXEC_WARM + 1} rounds, max |diff| "
                      f"over the state {diff:.3g}, metrics equal "
                      f"{g['metrics'] == e['metrics']}; the mean warm round "
                      f"{np.mean(e['walls']) / np.mean(g['walls']):.2f}x "
                      f"faster; on {card}")
                if diff != 0.0 or g["metrics"] != e["metrics"]:
                    fail(f"K_s {k_s} K_u {k_u}: the {name} executor's "
                         f"rounds differ from the eager one's (max |diff| "
                         f"{diff})")
                if g["counts"] != e["counts"]:
                    fail(f"K_s {k_s} K_u {k_u}: launches a round differ, "
                         f"{name} {g['counts']}, eager {e['counts']}")
                unseen = [k for k in ROUND_KERNELS if g["ours"][k][1] == 0]
                if unseen:
                    fail(f"the profiled {name} round shows no launch of "
                         f"{unseen}")
            del res, g, e
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7-12b: serving Qwen3-14B, xLSTM-1.3B, Zamba2-7B and DeepSeek-V2
# ---------------------------------------------------------------------------

# each serving path: arch -> ({its ported kernels' count name: profiler
# name}, the config cut in depth for the card-vs-CPU check, the log tag)
# (each "flash_kernel" name matches both flash kernels, "mamba2_scan_kernel"
# both Mamba2 kernels; the bf16 prefills must launch the wgmma and mma
# ones, the fp32 cross-checks the CUDA-core ones)
SERVE_PATHS = {
    "qwen3-14b": ({"flash_attention": "flash_kernel",
                   "flash_attention_wgmma": "flash_kernel_wgmma"},
                  lambda cfg: replace(cfg, num_layers=2), "serve-qwen3"),
    "xlstm-1.3b": ({"slstm_scan": "slstm_scan_kernel"},
                   lambda cfg: replace(cfg, num_layers=4, xlstm=replace(
                       cfg.xlstm, slstm_period=2)), "serve-xlstm"),
    "zamba2-7b": ({"mamba2_scan": "mamba2_scan_kernel",
                   "mamba2_scan_mma": "mamba2_scan_kernel_mma",
                   "flash_attention": "flash_kernel",
                   "flash_attention_wgmma": "flash_kernel_wgmma"},
                  lambda cfg: replace(cfg, num_layers=4,
                                      shared_attn_period=2), "serve-zamba2"),
    # the dense prefix layer (layer 0) and one MLA + MoE layer, split 1 + 1
    "deepseek-v2-236b": ({"flash_attention": "flash_kernel",
                          "flash_attention_wgmma": "flash_kernel_wgmma"},
                         lambda cfg: replace(cfg, num_layers=2),
                         "serve-deepseek"),
    # 2 layers, split 1 + 1; its card-vs-CPU check takes M-RoPE positions
    # whose planes differ (_grid_serve)
    "qwen2-vl-7b": ({"flash_attention": "flash_kernel",
                     "flash_attention_wgmma": "flash_kernel_wgmma"},
                    lambda cfg: replace(cfg, num_layers=2), "serve-qwen2vl"),
    # 2 encoder layers split 1 + 1, 1 decoder layer
    "seamless-m4t-medium": ({"flash_attention": "flash_kernel",
                             "flash_attention_wgmma": "flash_kernel_wgmma"},
                            lambda cfg: replace(cfg, num_layers=1,
                                                num_encoder_layers=2),
                            "serve-seamless"),
}
# the paths served cut in depth, for one card's 80 GB: DeepSeek-V2 at 9 of
# its 60 layers (the dense prefix layer and 8 MLA + MoE layers of 160
# experts, split 2 + 7): 33.16 B parameters, 61.8 GiB in bf16, about 70 GB
# at the peak with the (4, 2048, 102400) prefill logits
SERVE_DEPTH = {"deepseek-v2-236b": 9}


def _launches_per_prefill(cfg) -> dict:
    """Each ported kernel's launches in a prefill: flash attention once per
    attention layer (Qwen3, Qwen2-VL, DeepSeek-V2), per application of the
    shared block (Zamba2: after every period-th Mamba2 layer, on each side
    of the split), or once per encoder layer and twice per decoder layer
    (SeamlessM4T: self-attention and cross-attention), the sLSTM scan once
    per sLSTM block, the Mamba2 scan once per Mamba2 layer; in bf16 every
    flash launch is the wgmma kernel's and every Mamba2 launch the mma
    kernel's, in fp32 none."""
    if cfg.xlstm:
        return {"slstm_scan": cfg.num_layers // cfg.xlstm.slstm_period}
    want = {"flash_attention": cfg.num_layers
            + (cfg.num_layers + cfg.num_encoder_layers
               if cfg.is_encoder_decoder else 0)}
    if cfg.ssm:
        from repro_torch.models.transformer import build_model
        split, per = build_model(cfg).split, cfg.shared_attn_period
        want = {"mamba2_scan": cfg.num_layers,
                "flash_attention": split // per
                + (cfg.num_layers - split) // per}
        want["mamba2_scan_mma"] = (cfg.num_layers
                                   if cfg.dtype == "bfloat16" else 0)
    want["flash_attention_wgmma"] = (want["flash_attention"]
                                     if cfg.dtype == "bfloat16" else 0)
    return want


def _launches_per_decode_step(cfg) -> dict:
    """Each of a serving path's kernels' launches in a decode step: flash
    attention once per decoder layer for an encoder-decoder model (its
    cross-attention over the cross cache, one query row; self-attention
    decode is plain PyTorch), all the wgmma kernel's in bf16; none of any
    kernel on the other paths."""
    want = dict.fromkeys(_launches_per_prefill(cfg), 0)
    if cfg.is_encoder_decoder:
        want["flash_attention"] = cfg.num_layers
        want["flash_attention_wgmma"] = (cfg.num_layers
                                         if cfg.dtype == "bfloat16" else 0)
    return want


def _serve_cfg(arch: str):
    """The config a serving path runs at full width: the published one, cut
    in depth where ``SERVE_DEPTH`` says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = replace(cfg, num_layers=SERVE_DEPTH[arch])
    return cfg


def _serve_full(arch: str, log, tokens: int = SERVE_TOKENS):
    from repro_torch.launch.serve import serve_config
    return serve_config(_serve_cfg(arch), SERVE_BATCH, SERVE_PROMPT,
                        tokens, seed=0, device="cuda", log=log)


def _with_routing(cfg, fn):
    """``fn()``'s result and the routing records of its MoE layer calls
    (``moe.ROUTING``; none for a model without MoE)."""
    from repro_torch.models import moe
    moe.ROUTING = [] if cfg.moe is not None else None
    try:
        out = fn()
        return out, _routing_host(moe.ROUTING or [])
    finally:
        moe.ROUTING = None


def _routing_host(records: list) -> list:
    """``moe.ROUTING`` records (device tensors) read on the host: each
    call's tokens per expert as a list and its gap as a float."""
    return [{"counts": r["counts"].tolist(), "gap": float(r["gap"])}
            for r in records]


def _routing_line(records: list) -> str:
    """Tokens per expert (min and max over the experts of each MoE layer
    call) and the smallest gap between the k-th and (k+1)-th routing
    probability, over ``moe.ROUTING`` records."""
    lo = min(min(r["counts"]) for r in records)
    hi = max(max(r["counts"]) for r in records)
    gap = min(float(r["gap"]) for r in records)
    return (f"{len(records)} MoE layer calls, tokens per expert min {lo} "
            f"max {hi}, smallest gap between the k-th and (k+1)-th "
            f"routing probability {gap:.4g}")


def phase_serve(card: str, arch: str) -> dict:
    """The full model through the port's serving entry point: its
    parameters counted first, the previous path's memory freed and the
    peak-memory counter reset, every kernel's launch count set to 0 just
    before the run and read once the prefill has been logged and again
    just after.  Each of the path's kernels must run as often as
    :func:`_launches_per_prefill` says in the prefill and never in
    decode."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import moe
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_leaves
    kernels, _, tag = SERVE_PATHS[arch]
    cfg = _serve_cfg(arch)
    model = build_model(cfg)
    weights = tree_leaves(model.init(torch.Generator("cuda").manual_seed(0),
                                     "cuda"))
    print(f"[{tag}] {arch} as the model builds it: "
          f"{sum(t.numel() for t in weights) / 1e9:.4f} B parameters, "
          f"{sum(t.numel() * t.element_size() for t in weights) / 2**30:.3f}"
          f" GiB")
    del weights
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    after_log = []

    def log(msg):
        after_log.append((launch_counts(), len(moe.ROUTING or ())))
        print(f"[{tag}] {msg}")
    t0 = time.perf_counter()
    reset_launch_counts()
    res, routing = _with_routing(cfg, lambda: _serve_full(arch, log))
    launches = launch_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if routing:
        n_prefill = after_log[0][1]
        print(f"[{tag}] routing in the prefill: "
              f"{_routing_line(routing[:n_prefill])}; in decode: "
              f"{_routing_line(routing[n_prefill:])}")
    toks = res.tokens
    print(f"[{tag}] {arch} at full width, {cfg.num_layers} layers (split "
          f"{model.split} + {cfg.num_layers - model.split}), {cfg.dtype}, "
          f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_TOKENS} "
          f"tokens: prefill {res.prefill_s:.6f} s "
          f"({SERVE_BATCH * SERVE_PROMPT / res.prefill_s:.1f} prompt tok/s), "
          f"decode {SERVE_TOKENS - 1} steps in {res.decode_s:.6f} s "
          f"({(SERVE_TOKENS - 1) * SERVE_BATCH / res.decode_s:.1f} tok/s, "
          f"{res.decode_s / (SERVE_TOKENS - 1) * 1e3:.3f} ms per step), "
          f"{wall:.2f} s with weight init; peak device memory "
          f"{peak / 2**30:.2f} GiB; on {card}")
    print(f"[{tag}] launches on the serving path: {launches}")
    print(f"[{tag}] tokens of sequence 0: {toks[0].tolist()}")
    if not bool(torch.isfinite(res.logits.float()).all()):
        fail(f"serving {arch} gave non-finite prefill logits")
    if toks.shape != (SERVE_BATCH, SERVE_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"serving {arch} gave tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    want = _launches_per_prefill(cfg)
    want_decode = {k: (SERVE_TOKENS - 1) * n
                   for k, n in _launches_per_decode_step(cfg).items()}
    for kernel in kernels:
        prefill_n = after_log[0][0][kernel]
        decode_n = launches[kernel] - prefill_n
        print(f"[{tag}] {kernel} launches in the prefill {prefill_n} (want "
              f"{want[kernel]}), in the {SERVE_TOKENS - 1} decode steps "
              f"{decode_n} (want {want_decode[kernel]})")
        if prefill_n != want[kernel] or decode_n != want_decode[kernel]:
            fail(f"serving {arch} launched {kernel} {prefill_n} times in "
                 f"the prefill and {decode_n} in decode, want "
                 f"{want[kernel]} and {want_decode[kernel]}")
    return launches


def phase_serve_profile(card: str, arch: str) -> None:
    """The same serving run, to PROFILE_TOKENS tokens, under
    ``torch.profiler``: device busy time,
    idle share and device time by kernel, for the whole run and for each
    of its two spans (``serve.prefill``, ``serve.decode``: device ops are
    assigned to the span in which they start), with the share of each
    span's device time in each of the path's ported kernels.  The records
    are read raw (:func:`_device_ops`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    kernels, _, tag = SERVE_PATHS[arch]
    tag += "-profile"
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = _serve_full(arch, lambda _: None, PROFILE_TOKENS)
        wall = time.perf_counter() - t0
    device = [op for op in _device_ops(prof)
              if not op[0].startswith("serve.")]
    busy = sum(dur for _, _, dur in device) / 1e9
    ours = {k: sum(dur for n, _, dur in device if name in n) / 1e9
            for k, name in kernels.items()}
    print(f"[{tag}] under the profiler: prefill {res.prefill_s:.6f} "
          f"s, decode {res.decode_s:.6f} s, serve_config {wall:.6f} s "
          f"(weight init included); device busy {busy:.6f} s (idle share "
          f"{1 - busy / wall:.4f} of serve_config's wall); "
          + ", ".join(f"{k} {v:.6f} s" for k, v in ours.items())
          + f"; {len(device)} device ops; on {card}")
    spans = {e.name(): (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU
             and e.name() in ("serve.prefill", "serve.decode")}
    for span in ("serve.prefill", "serve.decode"):
        start, end = spans[span]
        inside = [op for op in device if start <= op[1] < end]
        by_name = _by_name(inside)
        span_busy = sum(t for _, t, _ in by_name)
        span_wall = (end - start) / 1e9
        shares = []
        for k, name in kernels.items():
            span_ours = sum(t for n, t, _ in by_name if name in n)
            shares.append(f"{k} {span_ours:.6f} s "
                          f"({span_ours / max(span_busy, 1e-12):.4f} of the "
                          f"device time)")
        print(f"[{tag}] span {span}: host {span_wall:.6f} s, "
              f"device busy {span_busy:.6f} s (idle share "
              f"{1 - span_busy / span_wall:.4f}), {len(inside)} device ops; "
              + "; ".join(shares))
        for name, t, n in by_name[:8]:
            print(f"[{tag}]   {span} device {t * 1e3:10.3f} ms x{n:<6d} "
                  f"{name[:90]}")
    print(f"[{tag}] the profiled run and its read took "
          f"{time.perf_counter() - t_all:.1f} s")


def _grid_serve(cfg, params, device: str, batch: int, prompt_len: int,
                gen_tokens: int):
    """A vision model's prefill and greedy decode through the port's steps,
    with M-RoPE positions whose planes differ: PATCHES patch embeddings
    (``randn``, seed 0) ahead of ``prompt_len`` tokens, at the positions
    of :func:`_grid_positions`, and the decode steps going on from the
    largest.  Returns what ``serve_config`` returns, with no times."""
    import torch

    from repro_torch.launch.serve import PATCHES, ServeResult
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import build_model
    rng = np.random.RandomState(0)
    pos = _grid_positions(PATCHES, prompt_len)
    dev = torch.device(device)
    host = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    batch_in = {"tokens": host(rng.randint(0, cfg.vocab_size,
                                           (batch, prompt_len))),
                "patch_embeds": host(rng.randn(batch, PATCHES, cfg.d_model)
                                     .astype(np.float32)),
                "mrope_positions": host(np.broadcast_to(
                    pos[:, None], (3, batch, pos.shape[1])))}
    cache = build_model(cfg).init_cache(batch, PATCHES + prompt_len
                                        + gen_tokens, dev)
    logits, cache = make_prefill_step(cfg)(params, batch_in, cache)
    tok = logits.argmax(-1)
    toks, decode = [tok], make_decode_step(cfg)
    for i in range(gen_tokens - 1):
        p = int(pos.max()) + 1 + i
        tok, cache = decode(params, {
            "tokens": tok[:, None],
            "pos": torch.full((batch,), p, dtype=torch.int64, device=dev),
            "mrope_positions": torch.full((3, batch, 1), p,
                                          dtype=torch.int64, device=dev)},
            cache)
        toks.append(tok)
    return ServeResult(torch.stack(toks, 1).cpu().numpy(), logits, 0.0, 0.0)


def phase_serve_cross_check(arch: str) -> None:
    """One prefill of 256 tokens and 4 decode steps of the model cut in
    depth (Qwen3-14B to 2 layers; xLSTM-1.3B to 4 blocks with an sLSTM
    block every 2, so 2 groups split 1 + 1; Zamba2-7B to 4 Mamba2 layers
    with the shared block every 2, split 2 + 2; DeepSeek-V2 to its prefix
    layer and one MLA + MoE layer, split 1 + 1; Qwen2-VL-7B to 2 layers,
    split 1 + 1, the prompt behind 8 patch embeddings with M-RoPE
    positions whose planes differ, :func:`_grid_serve`, where
    ``serve_config``'s text-only positions would reduce M-RoPE to RoPE;
    SeamlessM4T-medium to 2 encoder layers, split 1 + 1, and 1 decoder
    layer, 256 frames) at full width, in fp32 with TF32 off, on the card
    and on the CPU from the same weights (drawn on the card, copied to the
    CPU).  cuBLAS and the CPU sum in other orders and the path's kernels
    against their plain versions too, so the logits are held to 1e-3
    (phase 5's tolerance); the greedy tokens must be equal, and the card's
    run must launch each of the path's kernels as often as
    :func:`_launches_per_prefill` and, for each decode step,
    :func:`_launches_per_decode_step` say."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve_config
    from repro_torch.models.transformer import build_model
    from repro_torch.tree import tree_leaves, tree_map
    kernels, cut, tag = SERVE_PATHS[arch]
    cfg = replace(cut(get_config(arch)), dtype="float32")
    params = build_model(cfg).init(torch.Generator("cuda").manual_seed(1),
                                   "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = dict(batch=2, prompt_len=256, gen_tokens=5)
    if cfg.modality == "vision":
        run = lambda p, dev: _grid_serve(cfg, p, dev, **kw)
    else:
        run = lambda p, dev: serve_config(cfg, params=p, device=dev, seed=0,
                                          log=lambda _: None, **kw)
    t0 = time.perf_counter()
    reset_launch_counts()
    gpu, gpu_routing = _with_routing(cfg, lambda: run(params, "cuda"))
    counts = {k: launch_counts()[k] for k in kernels}
    cpu, cpu_routing = _with_routing(cfg, lambda: run(
        tree_map(lambda t: t.cpu(), params), "cpu"))
    del params
    if cpu_routing:
        # the CPU's routing is the reference's; a flip between the two
        # sides shows as another count of tokens for some expert
        same = [r["counts"] for r in gpu_routing] == \
            [r["counts"] for r in cpu_routing]
        print(f"[cross-{tag}] routing on the CPU over the positions "
              f"compared (the prefill's and the decode steps'): "
              f"{_routing_line(cpu_routing)}; card's tokens per expert "
              f"equal to the CPU's in every layer call: {same}")
    err = float((gpu.logits.cpu() - cpu.logits).abs().max())
    same = bool((gpu.tokens == cpu.tokens).all())
    print(f"[cross-{tag}] {arch} width {cfg.d_model}, {cfg.num_layers} "
          f"layers, {n_params / 1e9:.3f} B parameters, fp32: card vs CPU "
          f"last-position logits max|err| {err:.3g} (max|logit| "
          f"{float(cpu.logits.abs().max()):.3g}); greedy tokens equal: "
          f"{same} {gpu.tokens.tolist()}; launches on the card {counts}; "
          f"{time.perf_counter() - t0:.1f} s")
    per_step = _launches_per_decode_step(cfg)
    want = {k: n + (kw["gen_tokens"] - 1) * per_step[k]
            for k, n in _launches_per_prefill(cfg).items()}
    if counts != want:
        fail(f"the card's {arch} serving run launched {counts}, want "
             f"{want}")
    if not (torch.allclose(gpu.logits.cpu(), cpu.logits, atol=1e-3,
                           rtol=1e-3) and same):
        fail(f"the card and the CPU disagree on the {arch} serving path")


# ---------------------------------------------------------------------------
# phases 3b and 13-14: flash attention's backward and LM training
# ---------------------------------------------------------------------------

# the backward against its plain version at small shapes, fp32 and bf16:
# (b, h, kvh, sq, skv, hd, causal, window).  GQA groups 1, 4, 5 and 7 (hd
# 128, Qwen2-VL-7B's), ragged tiles, windows across tile edges, non-causal
# with Skv != Sq (SeamlessM4T's training cross-attention, 1024 rows over
# 4096 at hd 64, the last); phase 3b adds every head dim in bf16, rows that
# see no key, and the training paths' shapes
FLASH_BWD_CASES = [
    (1, 2, 1, 128, 128, 64, True, 0), (2, 8, 2, 384, 384, 80, True, 0),
    (1, 4, 4, 256, 256, 128, True, 64), (2, 2, 2, 128, 256, 64, False, 0),
    (1, 10, 2, 200, 200, 128, True, 0), (1, 5, 1, 77, 300, 96, False, 0),
    (1, 4, 2, 33, 33, 32, True, 16), (1, 4, 1, 300, 300, 112, True, 100),
    (1, 14, 2, 300, 300, 128, True, 0), (1, 16, 16, 1024, 4096, 64, False, 0)]
# (atol, rtol).  fp32: the forward's tolerance.  bf16: both sides compute
# in fp32 from the same bf16 inputs (and the same forward output and lse)
# and round each gradient once to bf16.  Where the two fp32 results x, y
# differ by e, the bf16 values differ by at most e plus one ulp of the
# larger, and one bf16 ulp of b is at most 2^-7 |b|: so rtol 2^-7, and an
# atol that bounds e, the fp32 gap of the sums' orders, which the fp32
# cases measure at danube's shape (below 3e-6 on an H100): 1e-5
FLASH_BWD_TOLS = {"float32": (2e-4, 2e-4), "bfloat16": (1e-5, 2.0 ** -7)}
# MLA's (192, 128) pair, in FLASH_BWD_CASES' style: (b, h, kvh, sq, skv,
# causal, window), the forward's FLASH_MLA_CASES shapes at unscaled q.
# The tolerance's atol assumes the fp32 sums of the two sides within 1e-5;
# under a peaked softmax (q scaled by 8) they are not, at equal head dims
# too (python3 scripts/flash_bwd_peaked_study.py on the card)
FLASH_BWD_MLA_CASES = [
    (1, 4, 4, 300, 300, True, 0), (2, 2, 2, 129, 129, True, 0),
    (1, 4, 4, 77, 300, False, 0), (1, 2, 2, 300, 77, False, 0),
    (1, 4, 2, 256, 256, True, 0), (1, 2, 2, 1000, 1000, True, 200),
    (1, 4, 4, 512, 512, True, 0)]
# H2O-Danube-1.8B at train_4k with the global batch cut to 4 sequences:
# the top's attention is q (4, 32, 4096, 80) over k, v (4, 8, 4096, 80)
LM_ARCH, LM_CLIENTS, LM_SEQ = "h2o-danube-1.8b", 4, 4096
LM_HEADS, LM_KV_HEADS, LM_HD = 32, 8, 80
LM_WINDOWS = (0, 1024)


# heads a plain-version call takes where the heads are not grouped (MLA's
# 128 heads of (4096, 4096) fp32 scores would take 8.6 GB a matrix)
REF_HEADS = 32


def _head_chunks(h: int, kvh: int) -> list:
    """Head slices to run the plain versions over: chunks of REF_HEADS
    where every query head has its own KV head, else all heads at once."""
    if h != kvh:
        return [slice(None)]
    return [slice(i, min(i + REF_HEADS, h)) for i in range(0, h, REF_HEADS)]


def _bwd_ref(q, k, v, o, lse, g, causal=True, window=0):
    """``ref.flash_attention_bwd_ref`` over :func:`_head_chunks`."""
    import torch

    from repro_torch.kernels import ref
    parts = [ref.flash_attention_bwd_ref(
        q[:, hs], k[:, hs], v[:, hs], o[:, hs], lse[:, hs], g[:, hs],
        causal=causal, window=window)
        for hs in _head_chunks(q.shape[1], k.shape[1])]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def _check_bwd(q, k, v, g, what, tol, causal=True, window=0) -> float:
    """The forward kernel's output and lse against their plain versions
    (one sequence and head chunk at a time), then the backward kernels
    against theirs on the forward kernel's output and lse; the gradients
    must come back in their inputs' dtypes and strides.  ``tol`` is the
    backward's (atol, rtol); the forward is held to ``FLASH_TOLS``.  v
    (and g, the output's gradient) may have a head dim of their own (MLA's
    pair)."""
    import torch

    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     with_lse=True)
    fwd_tol = FLASH_TOLS[str(q.dtype).removeprefix("torch.")]
    chunks = _head_chunks(q.shape[1], k.shape[1])
    o_err = 0.0
    for i in range(q.shape[0]):
        for hs in chunks:
            sl = (slice(i, i + 1), hs)
            o_want = ref.flash_attention_ref(q[sl], k[sl], v[sl],
                                             causal=causal,
                                             window=window).float()
            o_err = max(o_err, float((o[sl].float() - o_want).abs().max()))
            if not torch.allclose(o[sl].float(), o_want, atol=fwd_tol,
                                  rtol=fwd_tol):
                fail(f"flash forward {what} differs from the plain version "
                     f"by {o_err}")
            del o_want
    lse_want = torch.cat([ref.flash_attention_lse_ref(
        q[:, hs], k[:, hs], causal=causal, window=window) for hs in chunks],
        dim=1)
    seen = torch.isfinite(lse_want)
    if not (torch.equal(seen, torch.isfinite(lse))
            and torch.allclose(lse[seen], lse_want[seen], atol=1e-4,
                               rtol=1e-5)):
        fail(f"flash lse {what} differs from the plain version by "
             f"{float((lse[seen] - lse_want[seen]).abs().max())}")
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g, causal=causal,
                                      window=window)
    want = _bwd_ref(q, k, v, o, lse, g, causal=causal, window=window)
    torch.cuda.synchronize()
    wgmma = int(q.dtype == torch.bfloat16)
    if (fa.LAUNCHES["flash_attention_bwd"] - before["flash_attention_bwd"],
            fa.LAUNCHES["flash_attention_bwd_wgmma"]
            - before["flash_attention_bwd_wgmma"]) != (1, wgmma):
        fail(f"flash backward {what}: not counted once, or bf16 did not "
             "take the tensor-core kernels (or fp32 did)")
    atol, rtol = tol
    err, worst, sizes = 0.0, 0.0, []
    for name, gr, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        if gr.dtype != t.dtype or gr.stride() != t.stride():
            fail(f"flash backward {what}: {name} {gr.dtype} {gr.stride()}, "
                 f"want {t.dtype} {t.stride()}")
        a, b = gr.float(), w.float()
        e = float((a - b).abs().max())
        err = max(err, e)
        # each entry's error over its limit: allclose passes up to 1
        worst = max(worst, float(((a - b).abs() / (atol + rtol * b.abs()))
                                 .max()))
        sizes.append(f"{name} max {float(b.abs().max()):.3g} median "
                     f"{float(b.abs().median()):.3g}")
        if not torch.allclose(a, b, atol=atol, rtol=rtol):
            fail(f"flash backward {what}: {name} differs from the plain "
                 f"version by {e} (worst err / (atol + rtol |x|) {worst:.3g})")
    print(f"[kernels] flash backward {what}: forward max|err| {o_err:.3g} "
          f"(tol {fwd_tol}); gradients max|err| {err:.3g} (atol {atol:.3g}, "
          f"rtol {rtol:.3g}; worst err / (atol + rtol |x|) {worst:.3g}); "
          f"|x|: " + ", ".join(sizes))
    return err


def _model_views(gen, dt, b, s, h, kvh, hd, extra=(), hd_v=0):
    """q, k, v (and ``extra`` more tensors shaped like the output) as the
    model hands them over: (B, heads, S, hd) views of (B, S, heads, hd)
    tensors; v and the output have head dim ``hd_v`` where it is given."""
    import torch
    hd_v = hd_v or hd
    view = lambda n, d: torch.randn(b, s, n, d, generator=gen,
                                    device="cuda").to(dt).transpose(1, 2)
    return [view(h, hd), view(kvh, hd), view(kvh, hd_v)] + [
        view(h, hd_v) for _ in extra]


def _ptxas_rows(log: str, kernel: str) -> list:
    """One line a template instance of ``kernel`` from a ptxas report:
    its head dim, registers, shared memory, stack and spills."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(rf"{kernel}I((?:Li\d+E)+)E", line)
        if "Compiling entry function" in line:
            name = (f"{kernel}<"
                    + ", ".join(re.findall(r"Li(\d+)E", m.group(1))) + ">"
                    if m else None)
            if name:
                rows.append([name])
        elif name and ("spill" in line or "Used" in line):
            rows[-1].append(line.split(":", 1)[-1].strip())
    return [": ".join([r[0], "; ".join(r[1:])]) for r in rows]


def phase_flash_bwd(card: str, ptxas: str = "") -> dict:
    """Flash attention's backward on the card: every ``FLASH_BWD_CASES``
    entry and every ``FLASH_BWD_MLA_CASES`` entry (MLA's (192, 128) pair) in
    fp32 (the CUDA-core kernels) and bf16 (the tensor-core ones), every
    head dim in bf16, rows that see no key (zero gradients, no NaN; at
    equal dims and at the pair), then H2O-Danube-1.8B's training shape
    (model views) at windows 0 and 1024 in both types, and at head dims 64
    and 128, where two launches must agree bit for bit; then timed at that
    shape in bf16, causal (:func:`_time_flash_train`); then Zamba2-7B's
    shared-block training shape, q, k, v (4, 32, 4096, 112) bf16 causal
    views (hd 112, no GQA), checked and timed the same way; then
    DeepSeek-V2's MLA training shape, q, k (B, 128, 4096, 192) and v (B,
    128, 4096, 128) causal views at B 4 (bf16) and B 1 (bf16 and fp32),
    checked, two bf16 launches bit for bit, and timed."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    # the dK/dV kernel's third template argument: 3 both, 1 dV, 2 dK
    for kernel in ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"):
        for row in _ptxas_rows(ptxas, kernel):
            print(f"[kernels] flash backward ptxas: {row}")
    gen = torch.Generator(device="cuda").manual_seed(21)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    err = 0.0
    for dname, tol in FLASH_BWD_TOLS.items():
        dt = getattr(torch, dname)
        for b, h, kvh, sq, skv, hd, causal, window in FLASH_BWD_CASES:
            q, g = randn(b, h, sq, hd).to(dt), randn(b, h, sq, hd).to(dt)
            k, v = randn(b, kvh, skv, hd).to(dt), randn(b, kvh, skv, hd).to(dt)
            err = max(err, _check_bwd(
                q, k, v, g, f"{dname} q ({b}, {h}, {sq}, {hd}) kv ({kvh}, "
                f"{skv}) causal={causal} window={window}", tol, causal,
                window))
        # causal over 16 keys with a window of 8: rows 23 on see no key
        q, g = randn(1, 2, 64, 32).to(dt), randn(1, 2, 64, 32).to(dt)
        k = randn(1, 1, 16, 32).to(dt)
        o, lse = fa.flash_attention_cuda(q, k, k, window=8, with_lse=True)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, k, o, lse, g,
                                                 window=8)
        torch.cuda.synchronize()
        if not (bool(torch.isneginf(lse[:, :, 23:]).all())
                and all(bool(torch.isfinite(t.float()).all())
                        for t in (dq, dk, dv))
                and float(dq[:, :, 23:].float().abs().max()) == 0.0):
            fail(f"flash backward ({dname}): a row that sees no key has a "
                 "finite lse or a nonzero or NaN gradient")
        # MLA's pair, then rows that see no key
        for b, h, kvh, sq, skv, causal, window in FLASH_BWD_MLA_CASES:
            q = randn(b, h, sq, MLA_HD).to(dt)
            k = randn(b, kvh, skv, MLA_HD).to(dt)
            v, g = (randn(b, n, s_, MLA_HD_V).to(dt)
                    for n, s_ in ((kvh, skv), (h, sq)))
            err = max(err, _check_bwd(
                q, k, v, g, f"{dname} MLA q ({b}, {h}, {sq}, {MLA_HD}) kv "
                f"({kvh}, {skv}) v {MLA_HD_V} causal={causal} "
                f"window={window}", tol, causal, window))
        q, k = randn(1, 2, 64, MLA_HD).to(dt), randn(1, 2, 16, MLA_HD).to(dt)
        v, g = randn(1, 2, 16, MLA_HD_V).to(dt), randn(1, 2, 64,
                                                       MLA_HD_V).to(dt)
        o, lse = fa.flash_attention_cuda(q, k, v, window=8, with_lse=True)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g,
                                                 window=8)
        torch.cuda.synchronize()
        if not (bool(torch.isneginf(lse[:, :, 23:]).all())
                and all(bool(torch.isfinite(t.float()).all())
                        for t in (dq, dk, dv))
                and float(dq[:, :, 23:].float().abs().max()) == 0.0):
            fail(f"flash backward ({dname}, MLA's pair): a row that sees no "
                 "key has a finite lse or a nonzero or NaN gradient")
    tol = FLASH_BWD_TOLS["bfloat16"]
    for hd in fa.HEAD_DIMS:
        q, k, v, g = _model_views(gen, torch.bfloat16, 2, 300, 4, 2, hd,
                                  extra=(1,))
        err = max(err, _check_bwd(q, k, v, g, f"bf16 hd {hd} (model "
                                  "views)", tol))

    # the training path's shape, as views of the model's projections
    b, s, h, kvh = LM_CLIENTS, LM_SEQ, LM_HEADS, LM_KV_HEADS
    for hd in (LM_HD, 64, 128):
        for dname, tol in FLASH_BWD_TOLS.items():
            dt = getattr(torch, dname)
            q, k, v, g = _model_views(gen, dt, b, s, h, kvh, hd, extra=(1,))
            for window in LM_WINDOWS:
                what = (f"{dname} at {LM_ARCH}'s shape q {tuple(q.shape)} kv "
                        f"{tuple(k.shape)} window={window}")
                err = max(err, _check_bwd(q, k, v, g, what, tol,
                                          window=window))
            if hd == LM_HD and dname == "bfloat16":
                o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
                first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
                again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    fail("flash backward: two launches differ")
                timed = (q, k, v, g)
                del o, lse, first, again
            del q, k, v, g
            torch.cuda.empty_cache()

    timing = _time_flash_train(card, f"{LM_ARCH}'s training shape", *timed)
    del timed
    torch.cuda.empty_cache()
    # Zamba2-7B's shared attention block on the training path (no GQA),
    # the head dim's first training shape
    q, k, v, g = _model_views(gen, torch.bfloat16, b, s, ZAMBA_HEADS,
                              ZAMBA_HEADS, ZAMBA_HD, extra=(1,))
    err = max(err, _check_bwd(q, k, v, g, f"bf16 at zamba2-7b's training "
                              f"shape q {tuple(q.shape)} kv {tuple(k.shape)}",
                              FLASH_BWD_TOLS["bfloat16"]))
    _time_flash_train(card, "zamba2-7b's training shape", q, k, v, g)
    del q, k, v, g
    torch.cuda.empty_cache()
    # Qwen2-VL-7B's top on the training path (GQA 7 at hd 128), causal,
    # and SeamlessM4T-medium's cross-attention (1024 decoder rows over 4096
    # frames at hd 64, non-causal): two bf16 launches bit for bit, timed
    gqa7 = _model_views(gen, torch.bfloat16, b, s, QWEN2VL_HEADS,
                        QWEN2VL_KV_HEADS, 128, extra=(1,))
    t_new = time.perf_counter()
    view = lambda n, s_: torch.randn(b, s_, n, 64, generator=gen,
                                     device="cuda").bfloat16().transpose(1, 2)
    cross = (view(SEAMLESS_HEADS, 1024), view(SEAMLESS_HEADS, s),
             view(SEAMLESS_HEADS, s), view(SEAMLESS_HEADS, 1024))
    for where, (q, k, v, g), causal in (
            ("qwen2-vl-7b's training shape", gqa7, True),
            ("seamless-m4t-medium's training cross-attention", cross,
             False)):
        err = max(err, _check_bwd(
            q, k, v, g, f"bf16 at {where} q {tuple(q.shape)} kv "
            f"{tuple(k.shape)}", FLASH_BWD_TOLS["bfloat16"], causal=causal))
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         with_lse=True)
        first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g,
                                            causal=causal)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g,
                                            causal=causal)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            fail(f"flash backward at {where}: two launches differ")
        del o, lse, first, again
        _time_flash_train(card, where, q, k, v, g, causal=causal)
    del gqa7, cross, q, k, v, g
    torch.cuda.empty_cache()
    print(f"[kernels] flash backward at qwen2-vl-7b's and "
          f"seamless-m4t-medium's training shapes: checked and timed in "
          f"{time.perf_counter() - t_new:.1f} s")
    # DeepSeek-V2's MLA on the training path: q, k (B, 128, 4096, 192) and
    # v (B, 128, 4096, 128), views of the model's (B, S, H, d) tensors, at
    # the top's B 4 (bf16) and a client bottom's B 1 (bf16 and fp32)
    t_mla = time.perf_counter()
    for b_mla, dnames in ((b, ("bfloat16",)), (1, ("bfloat16", "float32"))):
        for dname in dnames:
            dt = getattr(torch, dname)
            q, k, v, g = _model_views(gen, dt, b_mla, s, DEEPSEEK_HEADS,
                                      DEEPSEEK_HEADS, MLA_HD, extra=(1,),
                                      hd_v=MLA_HD_V)
            where = f"deepseek-v2-236b's training shape (B {b_mla})"
            err = max(err, _check_bwd(
                q, k, v, g, f"{dname} at {where} q {tuple(q.shape)} v "
                f"{tuple(v.shape)}", FLASH_BWD_TOLS[dname]))
            if dname == "bfloat16":
                o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
                first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
                again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    fail(f"flash backward at {where}: two launches differ")
                del o, lse, first, again
                _time_flash_train(card, where, q, k, v, g)
            del q, k, v, g
            torch.cuda.empty_cache()
    print(f"[kernels] flash backward at deepseek-v2-236b's training shape: "
          f"checked and timed in {time.perf_counter() - t_mla:.1f} s")
    return {"err": err, "timing": timing}


def _time_flash_train(card: str, where: str, q, k, v, g,
                      causal: bool = True) -> dict:
    """Flash attention at one bf16 training shape, causal unless
    ``causal`` is False (Sq may then differ from Skv): the forward (with
    its lse) and the backward, each timed against the library
    (``scaled_dot_product_attention``: its forward, and its forward and
    backward less its forward, with the backend it took named) and its
    bound, the backward also against its plain version (over
    :func:`_head_chunks`), with its rate counted over the 5 products the
    bound counts and over those the bf16 kernels issue.  v and g may have
    a head dim of their own (MLA's pair): S, dQ and dK are products over
    q's head dim, P V, dP and dV over v's.  A library call that fails (no
    backend, or out of memory) is reported and left out.  Returns the
    backward's times and bound, for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, h, sq, hd = q.shape
    hd_v = v.shape[-1]
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    pairs = _attn_pairs(sq, k.shape[2], causal, 0)
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    # operations a visible pair in the products the bf16 kernels issue: S
    # twice (three times at a pair, dV and dK in two passes), dP twice, P
    # and dS in BWD_KV_TERMS terms for dV and dK, dS in BWD_DQ_TERMS for dQ
    n_s = 2 if hd == hd_v else 3
    issued = 2 * (n_s * hd + 2 * hd_v + fa.BWD_KV_TERMS * (hd + hd_v)
                  + fa.BWD_DQ_TERMS * hd)
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        lq, lk, lv, is_causal=causal, enable_gqa=k.shape[1] != h)
    t = dict(
        fwd=time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, with_lse=True), iters=5, warmup=1),
        bwd=time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, g, causal=causal), iters=5, warmup=1),
        plain=time_ms(lambda: _bwd_ref(q, k, v, o, lse, g, causal=causal),
                      iters=3, warmup=1))
    lib_kernels: dict = {}
    try:
        t["lib_fwd"] = time_ms(lambda: sdpa().detach(), iters=10, warmup=2)
        t["lib_fwd_bwd"] = time_ms(lambda: torch.autograd.grad(
            sdpa(), (lq, lk, lv), g), iters=10, warmup=2,
            by_kernel=lib_kernels)
        library = (t["lib_fwd_bwd"][0] - t["lib_fwd"][0],
                   t["lib_fwd_bwd"][1] - t["lib_fwd"][1])
        print(f"[timing] flash_attention_bwd at {where}: the library call "
              f"takes the {_sdpa_backend(lib_kernels)} backend; its "
              "kernels " + ", ".join(f"{n[:70]} {ms:.4f} ms" for n, ms in
                                     lib_kernels.items()))
    except (RuntimeError, torch.OutOfMemoryError) as e:
        t["lib_fwd"] = library = None
        print(f"[timing] flash_attention at {where}: no library time, "
              f"scaled_dot_product_attention raised "
              f"{str(e).splitlines()[0][:200]}")
        torch.cuda.empty_cache()
    shape = (f"q {tuple(q.shape)} kv {tuple(k.shape)}"
             + (f" v {tuple(v.shape)}" if hd_v != hd else "")
             + (" bf16 causal" if causal else " bf16 non-causal"))
    lib_text = lambda lib: ("no library time" if lib is None else
                            f"{lib[0]:.4f} ms (events {lib[1]:.4f})")
    out = {}
    for name, n_prod, per_pair, n_bytes in (
            ("forward", 2, 2 * (hd + hd_v), size(q, k, v, o)
             + lse.numel() * 4),
            ("backward", 5, 2 * (3 * hd + 2 * hd_v), 2 * size(q, k, v)
             + size(o, g) + lse.numel() * 4)):
        n_flops = per_pair * b * h * pairs
        bound = bound_ms(n_bytes, n_flops, PEAK_BF16_FLOPS)
        if name == "forward":
            ms, lib = t["fwd"], t["lib_fwd"]
            detail = (f"library (scaled_dot_product_attention) "
                      f"{lib_text(lib)}")
            rate = f"{n_flops / ms[0] / 1e9:.1f} TFLOP/s"
            label = "flash forward (with lse)"
        else:
            ms, lib = t["bwd"], library
            detail = (f"plain {t['plain'][0]:.4f} ms (events "
                      f"{t['plain'][1]:.4f}), library "
                      f"(scaled_dot_product_attention forward + backward "
                      f"less forward) {lib_text(lib)}")
            rate = (f"{n_flops / ms[0] / 1e9:.1f} TFLOP/s counting the 5 "
                    f"products, "
                    f"{issued * b * h * pairs / ms[0] / 1e9:.1f} counting "
                    f"the {issued} operations a pair the bf16 kernels issue "
                    f"(S {n_s} times, dP twice; P and dS as "
                    f"{fa.BWD_KV_TERMS} bf16 terms for dK and dV, dS as "
                    f"{fa.BWD_DQ_TERMS} for dQ)")
            label = "flash_attention_bwd"
            out = {"ms": ms[0], "plain_ms": t["plain"][0],
                   "library_ms": None if lib is None else lib[0],
                   "bound": bound}
        print(f"[timing] {label} at {where}, {shape} ({n_flops:.4g} "
              f"operations in {n_prod} products, {n_bytes / 1e6:.1f} MB): "
              f"kernel {ms[0]:.4f} ms (events {ms[1]:.4f}), {detail}, bound "
              f"{bound[0]:.4f} ms ({bound[1]}; "
              f"{n_flops / PEAK_FP32_FLOPS * 1e3:.4f} ms at the fp32 "
              f"CUDA-core peak); kernel at {rate}, "
              f"{bound[0] / ms[0]:.4f} of the bound"
              + ("" if lib is None else
                 f", {ms[0] / lib[0]:.2f}x the library's time")
              + f"; on {card}")
    del o, lse, lq, lk, lv
    return out


def _lm_plan(cfg, n: int, seq: int):
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch.steps import make_plan
    return make_plan(cfg, replace(INPUT_SHAPES["train_4k"], seq_len=seq,
                                  global_batch=n), n_clients=n)


def _grid_positions(p: int, s_text: int) -> np.ndarray:
    """(3, p + s_text) M-RoPE positions whose planes differ: one image grid
    of ``p`` patches, rows x columns as square as ``p`` allows (temporal
    0, height the patch's row, width its column), ahead of ``s_text``
    tokens at the grid's largest position + 1 on, on all three planes."""
    rows = max(r for r in range(1, int(p ** 0.5) + 1) if p % r == 0)
    cols = p // rows
    r, c = np.divmod(np.arange(p), cols)
    start = max(rows, cols)
    text = np.arange(start, start + s_text)
    return np.concatenate([np.stack([np.zeros_like(r), r, c]),
                           np.broadcast_to(text, (3, s_text))], axis=1)


def _lm_batches(cfg, k: int, n: int, seq: int, seed: int) -> dict:
    """K steps of train batches for N clients x 1 sequence of ``seq``
    positions, in ``train_batch_shapes``' shapes with a leading K, drawn on
    the card from ``seed``: fresh strong views every step, and the same N
    weak views in each (each client revisits its unlabeled data), so that
    from the second step on the teacher's sequence pseudo-labels find their
    own earlier entries in the queue and Eq. (5) has positives.  Token ids
    uniform over the vocabulary; a vision model's patch embeddings
    (``randn``, in the config's dtype) the same in every step and view,
    and its M-RoPE positions :func:`_grid_positions`; an encoder-decoder
    model's frames
    ``randn`` and its decoder tokens the same every step."""
    import torch

    from repro_torch.launch.steps import train_batch_shapes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = train_batch_shapes(_lm_plan(cfg, n, seq))
    out = {}
    for key, (shape, dt) in shapes.items():
        k_ = k if key.endswith("_strong") else 1
        if key == "mrope_positions":
            p = shapes["patch_embeds"][0][-2]
            pos = _grid_positions(p, shape[-1] - p)
            x = torch.from_numpy(pos).cuda()[:, None].expand(shape)[None]
        elif dt == torch.int64:
            x = torch.randint(0, cfg.vocab_size, (k_,) + shape,
                              generator=gen, device="cuda")
        else:
            x = torch.randn((k_,) + shape, generator=gen,
                            device="cuda").to(dt)
        out[key] = x.expand((k,) + shape)
    return out


def _lm_launches(cfg, n: int, wire) -> dict:
    """Each kernel's launches in one LM train step.  Each client's bottom
    runs on its own batch, the top on the flat one, in three forward
    passes: the teacher's, the student's and the student's recompute in
    the backward pass.  Dense: flash attention once per layer a pass, all
    the wgmma kernel's in bf16, and its backward once per layer (the
    tensor-core kernels in bf16).  xLSTM: the sLSTM scan once per sLSTM
    block a pass (one a group), its backward once per block; no flash.
    The Zamba2 hybrid: the Mamba2 scan once per Mamba2 layer a pass (all
    the mma kernel's in bf16), its backward once per layer, and flash
    attention once per application of the shared block a pass (one after
    every ``shared_attn_period`` layers of each side), its backward once
    per application.  The vision decoder as the dense one.  The
    encoder-decoder model: flash attention once per encoder layer and
    twice per decoder layer (self and cross) a pass, its backward as
    often.  All: the clustering pair once; the int8 wire's
    two-pass quantizer (a
    client slice of S x d_model floats is past what a cluster holds) three
    times: teacher and student features, and the cut's gradient, where the
    wire is ``int8``."""
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    quant = 3 if wire == "int8" else 0
    want = {"clustering_fwd": 1, "clustering_bwd": 1, "quantize_amax": quant,
            "quantize_qdq": quant, "quantize_fused": 0, "mamba2_scan": 0,
            "mamba2_scan_bwd": 0, "mamba2_scan_bwd_mma": 0}
    if cfg.xlstm:
        blocks = n * model.split_groups + model.n_groups - model.split_groups
        return dict(want, slstm_scan=3 * blocks, slstm_scan_bwd=blocks,
                    flash_attention=0, flash_attention_bwd=0)
    layers = n * model.split + cfg.num_layers - model.split
    if cfg.is_encoder_decoder:
        layers = (n * model.split + cfg.num_encoder_layers - model.split
                  + 2 * cfg.num_layers)
    bf16 = cfg.dtype == "bfloat16"
    if cfg.ssm:
        per = cfg.shared_attn_period
        apps = n * (model.split // per) + (cfg.num_layers - model.split) // per
        return dict(want, mamba2_scan=3 * layers,
                    mamba2_scan_mma=3 * layers if bf16 else 0,
                    mamba2_scan_bwd=layers,
                    mamba2_scan_bwd_mma=layers if bf16 else 0,
                    flash_attention=3 * apps,
                    flash_attention_wgmma=3 * apps if bf16 else 0,
                    flash_attention_bwd=apps,
                    flash_attention_bwd_wgmma=apps if bf16 else 0,
                    slstm_scan=0, slstm_scan_bwd=0)
    return dict(want, flash_attention=3 * layers,
                flash_attention_wgmma=3 * layers if bf16 else 0,
                flash_attention_bwd=layers,
                flash_attention_bwd_wgmma=layers if bf16 else 0,
                slstm_scan=0, slstm_scan_bwd=0)


# the LM training paths: arch -> (the log tag; the depth and rate of the
# trained config; the config cut in depth for the card-vs-CPU step and its
# tokens a client there; the profiler names of the path's ported kernels;
# a kernel that must not run in the bf16 step).  Danube trains at full
# depth and JAX's default rate.  xLSTM-1.3B trains at full width cut to 16
# blocks (its first two groups of 7 mLSTM + 1 sLSTM, split 1 + 1) at rate
# 2e-4: at random init the SemiSFL step (plain SGD, each client's bottom
# gradient times N) meets a first gradient of 8.4e4 on a client bottom at
# 48 blocks (172 at 16) and takes them to non-finite values in the second
# step at rates 2e-4 and 2e-5, and 24 blocks in the third, where 16 stay
# finite (scripts/lm_depth_probe.py); JAX's step from its own init does
# the same at the smoke width (the study in tests/test_torch_xlstm_train.py).
# At a rate that keeps 48 blocks finite (2e-8) the random model's
# pseudo-labels gave Eq. (5) no positive in 4 steps.  Zamba2-7B trains at
# full width cut to ZAMBA_TRAIN_LAYERS Mamba2 layers (split 12 + 54, the
# shared block after every 6 on each side), at JAX's rate: the full 81
# layers' bf16 state, gradients and the teacher update need about 87 GB
# before any activation; 72 layers ran out of the 79.18 GiB, 66 peaked at
# 63.522 GiB and stayed finite at 0.02 (scripts/lm_depth_probe.py --arch
# zamba2-7b), its 3 timed steps one call of the donated phase like the
# others' (a K-step call of the eager loop, ``make_train_phase``, holds the
# caller's state beside its own, a second 35.6 GiB).  Its
# card-vs-CPU step takes two periods of the shared block split 1 + 1
# period, so that each side applies it once, as phase 12 does: 4 layers,
# the block every 2, a layout the published model (the block every 6)
# does not have, which still runs every fp32 kernel of the path (two
# periods of 6 layers took that phase 177.6 s, most of it the full-width
# fp32 state on the host), over 128 tokens a client (two of the scan
# kernels' 64-step chunks).  DeepSeek-V2 trains at full width cut to
# DEEPSEEK_TRAIN_LAYERS (the dense prefix layer in each client's bottom,
# MLA + MoE layers of 160 experts in the top; an MoE layer is about 7.95 GB
# in bf16, and the state holds the top twice and 8 bottoms) at JAX's rate.
# Its card-vs-CPU step and graph check cannot hold two full-width states:
# they take d_model 1024 with 16 heads and 16 experts (top 6 of 1536, 2
# shared), the published MLA ranks and head dims (q/k 192 over v 128),
# d_ff and vocabulary, 2 layers split 1 + 1, over 256 tokens a client.
# Qwen2-VL-7B trains at full width cut to QWEN2VL_TRAIN_LAYERS (the split
# a quarter of them): its step holds fp32 tensors over the 152,064-word
# vocabulary for 4 x 4096 positions, 9.28 GiB each (the teacher's softmax,
# the student's log-softmax and its gradient), beside the state (1.63 GB a
# layer across 8 bottoms and 2 tops) and the gradients (python3
# scripts/lm_depth_probe.py --arch qwen2-vl-7b --graph); its card-vs-CPU
# step takes 2 layers over 128 positions a client (32 patch embeddings).
# SeamlessM4T-medium trains at full depth; its card-vs-CPU step and graph
# check take 2 encoder layers (split 1 + 1) and 1 decoder layer
ZAMBA_TRAIN_LAYERS = 66
DEEPSEEK_TRAIN_LAYERS = 2
QWEN2VL_TRAIN_LAYERS = 14
# the graph-against-eager check's positions a client where LM_SEQ's do not
# fit: the eager K=3 call holds three states of the 2-layer Qwen2-VL-7B
# (14.5 GiB each) beside the step's fp32 vocabulary tensors
GRAPH_SEQ = {"qwen2-vl-7b": 2048}
# the flash kernels a path's profiled bf16 step must show, and the fp32
# backward kernels it must not
FLASH_TRAIN_NAMES = ("flash_kernel_wgmma", "flash_bwd_delta",
                     "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma")
FLASH_REFUSED = ("flash_bwd_dkdv<", "flash_bwd_dq<")
LM_TRAIN_PATHS = {
    "h2o-danube-1.8b": (
        "lm-train", None, 0.02,
        lambda cfg: replace(cfg, num_layers=2, semisfl=replace(
            cfg.semisfl, split_layer=1)), 512,
        ("flash_kernel_wgmma", "flash_bwd_delta", "flash_bwd_dkdv_wgmma",
         "flash_bwd_dq_wgmma", "clustering_", "amax_kernel", "qdq_kernel"),
        ("flash_bwd_dkdv<", "flash_bwd_dq<")),
    "xlstm-1.3b": (
        "lm-train-xlstm", 16, 2e-4,
        lambda cfg: replace(cfg, num_layers=4, xlstm=replace(
            cfg.xlstm, slstm_period=2)), 256,
        ("slstm_scan_kernel", "slstm_scan_bwd_mma", "clustering_",
         "amax_kernel", "qdq_kernel"), ("slstm_scan_bwd_kernel<",)),
    "zamba2-7b": (
        "lm-train-zamba2", ZAMBA_TRAIN_LAYERS, 0.02,
        lambda cfg: replace(cfg, num_layers=4, shared_attn_period=2,
                            semisfl=replace(cfg.semisfl, split_layer=2)),
        128,
        ("mamba2_scan_kernel_mma", "mamba2_bwd_cb",
         "mamba2_scan_bwd_mma_kernel", "mamba2_bwd_epilogue",
         "flash_kernel_wgmma", "flash_bwd_delta", "flash_bwd_dkdv_wgmma",
         "flash_bwd_dq_wgmma", "clustering_", "amax_kernel", "qdq_kernel"),
        ("flash_bwd_dkdv<", "flash_bwd_dq<", "mamba2_scan_kernel(",
         "mamba2_scan_bwd_kernel<", "mamba2_scan_bwd_merge")),
    "deepseek-v2-236b": (
        "lm-train-deepseek", DEEPSEEK_TRAIN_LAYERS, 0.02,
        lambda cfg: replace(cfg, num_layers=2, d_model=1024, num_heads=16,
                            num_kv_heads=16,
                            moe=replace(cfg.moe, num_experts=16),
                            semisfl=replace(cfg.semisfl, split_layer=1)),
        256,
        ("flash_kernel_wgmma", "flash_bwd_delta", "flash_bwd_dkdv_wgmma",
         "flash_bwd_dq_wgmma", "clustering_", "amax_kernel", "qdq_kernel"),
        ("flash_bwd_dkdv<", "flash_bwd_dq<")),
    "qwen2-vl-7b": (
        "lm-train-qwen2vl", QWEN2VL_TRAIN_LAYERS, 0.02,
        lambda cfg: replace(cfg, num_layers=2, semisfl=replace(
            cfg.semisfl, split_layer=1)), 128,
        FLASH_TRAIN_NAMES + ("clustering_", "amax_kernel", "qdq_kernel"),
        FLASH_REFUSED),
    "seamless-m4t-medium": (
        "lm-train-seamless", None, 0.02,
        lambda cfg: replace(cfg, num_layers=1, num_encoder_layers=2), 256,
        FLASH_TRAIN_NAMES + ("clustering_", "amax_kernel", "qdq_kernel"),
        FLASH_REFUSED),
}


def _check_moe_route(card: str, cfg, tag: str) -> None:
    """The MoE layer's expert route on the card against its plain version:
    one MoE layer of ``cfg`` at full width (bf16, weights drawn from seed
    4), one client's 4096 tokens, through ``moe.apply_moe`` on the grouped
    products and on the per-expert loop (``route=``): the output, the aux
    loss and the gradients of x, the router and the experts, for one
    output cotangent.  Each leaf's largest difference must stay within
    2^-7 of the leaf's largest magnitude (one bf16 ulp at its scale: the
    two routes' products sum in other orders before the bf16 rounding),
    and the aux loss must be equal (the routing is one computation)."""
    import torch

    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = moe.init_moe(cfg, gen, "cuda", torch.bfloat16)
    x = torch.randn(1, LM_SEQ, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    g = torch.randn(1, LM_SEQ, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    runs = {}
    for route in ("grouped", "loop"):
        leaves = {"x": x.clone().requires_grad_(True),
                  "router": p["router"].clone().requires_grad_(True),
                  **{f"experts.{k}": v.clone().requires_grad_(True)
                     for k, v in p["experts"].items()}}
        q = dict(p, router=leaves["router"], experts={
            k: leaves[f"experts.{k}"] for k in p["experts"]})
        out, aux = moe.apply_moe(q, cfg, leaves["x"], route=route)
        grads = torch.autograd.grad((out.float() * g.float()).sum() + aux,
                                    list(leaves.values()))
        runs[route] = ({"out": out.detach(), "aux": aux.detach(),
                        **dict(zip(leaves, grads))})
        del leaves, q, out, aux, grads
    torch.cuda.synchronize()
    rel = {k: float((runs["grouped"][k].float() - runs["loop"][k].float())
                    .abs().max() / runs["loop"][k].float().abs().max()
                    .clamp_min(1e-30)) for k in runs["loop"]}
    print(f"[{tag}] the expert route on the card, one MoE layer at full "
          f"width ({cfg.moe.num_experts} experts, top {cfg.moe.top_k}), "
          f"bf16, {LM_SEQ} tokens: grouped products against the per-expert "
          f"loop, max|diff| / max|loop| " + ", ".join(
              f"{k} {v:.3g}" for k, v in rel.items()) + f"; on {card}")
    if rel["aux"] != 0.0 or max(rel.values()) > 2.0 ** -7:
        fail(f"the grouped expert route differs from the per-expert loop: "
             f"{rel}")
    del runs, p, x, g
    torch.cuda.empty_cache()


def phase_lm_train(card: str, arch: str) -> dict:
    """An LM training path at full width (and the depth and rate of
    LM_TRAIN_PATHS), bf16, through
    ``repro_torch.launch.steps.make_scanned_train_phase`` (the step one CUDA
    graph, the state donated) with the ``int8`` wire and tau 0: 4 clients x
    1 sequence x 4096 tokens (train_4k's sequence; the global batch cut
    from 256 to 4 for one card's memory), weights and tokens from seed 0
    (the weak views the same sequences each step, see :func:`_lm_batches`).
    A first call of one step (the graph's warm-up steps, its capture and
    one replay), then 3 timed steps in one call (host clock ending in a
    synchronize), every kernel's count set to 0 just before the first call
    and read after the timed one; peak device memory; then one replayed
    step under ``torch.profiler`` (its device ops read raw,
    :func:`_device_ops`).
    Fails unless every metric is finite, Eq. (5) is live after the first
    step, the top, the bottoms and the teacher bottoms moved, the queue's
    pointer advanced, every leaf of the state is finite, each kernel ran
    as often as :func:`_lm_launches` says in each of the 4 steps and the
    WARMUP_STEPS eager warm-up steps, and the profiled step shows each of
    the path's kernels.  An MoE path also prints its routing over the
    first call's eager warm-up steps (``moe.ROUTING``, set for that call
    and read after it): tokens per expert and the smallest gap between the
    k-th and (k+1)-th routing probability; and, before its state is drawn,
    holds its MoE layer's grouped expert route to the per-expert loop
    (:func:`_check_moe_route`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.scan import WARMUP_STEPS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (init_train_state,
                                          make_scanned_train_phase)
    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves
    tag, depth, lr, _, _, names, refused = LM_TRAIN_PATHS[arch]
    base = get_config(arch)
    cfg = replace(base, num_layers=depth or base.num_layers,
                  semisfl=replace(base.semisfl, confidence_threshold=0.0))
    plan = _lm_plan(cfg, LM_CLIENTS, LM_SEQ)
    if cfg.moe is not None:
        _check_moe_route(card, cfg, tag)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(plan, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tensors = lambda tree: [t for t in tree_leaves(tree)
                            if isinstance(t, torch.Tensor)]
    n_params = sum(t.numel() for t in tensors(
        [state["client_bottoms"][0], state["top"]]))
    n_bytes = sum(t.numel() * t.element_size() for t in tensors(state))
    print(f"[{tag}] {arch} as built: {n_params / 1e9:.4f} B "
          f"parameters (one bottom + the top); the state "
          f"{n_bytes / 2**30:.3f} GiB ({LM_CLIENTS} client and teacher "
          f"bottoms, top, teacher top, heads, queue); drawn in "
          f"{init_s:.2f} s")
    # copies on the host, so that they do not count in the peak
    snap = lambda st: [[t.cpu() for t in tensors(tree)] for tree in (
        st["top"], st["client_bottoms"][0], st["teacher_bottoms"][0])] + [
        int(st["queue"].ptr)]
    before = snap(state)
    tokens = _lm_batches(cfg, 5, LM_CLIENTS, LM_SEQ, seed=0)
    phase = make_scanned_train_phase(plan, lr=lr, wire="int8")
    part = lambda a, b: {k: v[a:b] for k, v in tokens.items()}

    reset_launch_counts()
    moe.ROUTING = [] if cfg.moe is not None else None
    t0 = time.perf_counter()
    try:
        state, m_warm = phase(state, part(0, 1))
        torch.cuda.synchronize()
        # the warm-up steps' records; the capture's come last
        records = moe.ROUTING or []
        records = _routing_host(records[:len(records) * WARMUP_STEPS
                                        // (WARMUP_STEPS + 1)])
    finally:
        moe.ROUTING = None
    first_s = time.perf_counter() - t0
    (graph,) = phase.graphs.values()
    t0 = time.perf_counter()
    state, m = phase(state, part(1, 4))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: torch.cat([m_warm[k], m[k]]).tolist() for k in m}
    tokens_step = LM_CLIENTS * LM_SEQ
    print(f"[{tag}] {arch} full width, {cfg.num_layers} of "
          f"{base.num_layers} layers, bf16, int8 wire, tau 0, rate {lr}, "
          f"{LM_CLIENTS} clients x 1 x {LM_SEQ} tokens, through the graph "
          f"(state donated): first call {first_s:.4f} s ({WARMUP_STEPS} "
          f"warm-up steps and the capture {graph.capture_s:.4f} s, then a "
          f"replay); 3 timed steps in one call {wall:.6f} s a step, "
          f"{tokens_step / wall:.1f} tokens/s; peak device memory "
          f"{peak / 2**30:.3f} GiB; on {card}")
    if records:
        print(f"[{tag}] routing in the {WARMUP_STEPS} warm-up steps: "
              f"{_routing_line(records)}")
    print(f"[{tag}] metrics of the 4 steps: " + "; ".join(
        f"{k} {', '.join(f'{x:.6g}' for x in v)}" for k, v in
        metrics.items()))
    want = _lm_launches(cfg, LM_CLIENTS, "int8")
    steps_run = WARMUP_STEPS + 4
    print(f"[{tag}] launches in the {WARMUP_STEPS} warm-up and 4 replayed "
          f"steps: {launches}; want a step: {want}; captured a step: "
          f"{ {k: v for k, v in graph.launches.items() if v} }")
    for kernel, n in want.items():
        if launches[kernel] != steps_run * n or graph.launches[kernel] != n:
            fail(f"{arch} training launched {kernel} {launches[kernel]} "
                 f"times in {steps_run} steps ({graph.launches[kernel]} "
                 f"captured a step), want {steps_run * n} ({n})")
    if not np.isfinite([x for v in metrics.values() for x in v]).all():
        fail(f"{arch} training gave non-finite metrics {metrics}")
    if max(metrics["clustering"][1:]) <= 0.0:
        fail(f"{arch} training: Eq. (5) found no positive after the first "
             f"step")
    after = snap(state)
    moved = [max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(was, now))
             for was, now in zip(before[:3], after[:3])]
    print(f"[{tag}] max|change| over 4 steps, over every leaf: the top "
          f"{moved[0]:.4g}, client 0's bottom {moved[1]:.4g}, its "
          f"teacher {moved[2]:.4g}; queue ptr {before[3]} -> {after[3]}")
    if not (np.isfinite(moved).all() and min(moved) > 0.0) \
            or after[3] == before[3]:
        fail(f"{arch} training: a parameter group or the queue did not "
             f"move")
    bad = [i for i, t in enumerate(tensors(state))
           if not bool(torch.isfinite(t.float()).all())]
    if bad:
        fail(f"{arch} training: {len(bad)} leaves of the state are not "
             f"finite after 4 steps")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = phase(state, part(4, 5))
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    ops = _device_ops(prof)
    kernels = _by_name(ops)
    busy = sum(t for _, t, _ in kernels)
    ours = _ours(kernels, names)
    print(f"[{tag}-profile] one replayed step under the profiler: wall "
          f"{wall_prof:.6f} s, device busy {busy:.6f} s (idle share "
          f"{1 - busy / wall_prof:.4f}), {len(ops)} device ops; " + ", ".join(
              f"{k} {t:.6f} s x{n} ({t / max(busy, 1e-12):.4f} of the device "
              "time)"
              for k, (t, n) in ours.items()) + f"; profiler and its read "
          f"{time.perf_counter() - t0 - wall_prof:.1f} s; on {card}")
    for k, t, c in kernels[:12]:
        print(f"[{tag}-profile] device {t * 1e3:10.3f} ms x{c:<6d} "
              f"{k[:100]}")
    if any(n == 0 for _, n in ours.values()):
        fail(f"the profiled {arch} step shows no launch of some kernel: "
             f"{ours}")
    wrong = [k for k, _, _ in kernels if any(r in k for r in refused)]
    if wrong:
        fail(f"the bf16 {arch} step ran the CUDA-core backward: {wrong}")
    del state, prof, ops, phase, graph
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_lm_cross_check(arch: str) -> None:
    """One LM train step on the card against the same step on the CPU:
    ``arch`` at full width cut in depth (LM_TRAIN_PATHS: danube to 2
    layers, split 1 + 1; xLSTM to 4 blocks with an sLSTM every 2, split 1
    + 1 group; Zamba2 to 4 Mamba2 layers with the shared block every 2,
    split 2 + 2), fp32 with TF32 off, 2 clients x 1 sequence (512 tokens
    for danube, 256 for xLSTM: two mLSTM chunks, so the chunk carry is
    differentiated; 128 for Zamba2, two chunks of the scan kernels), tau
    0, no wire, from one state (drawn on the card
    from seed 1, then one step on the same batch to fill the queue) copied
    to the CPU.  Every metric and every leaf of the new state within 1e-3
    (cuBLAS and the CPU sum in other orders, the kernels against their
    plain versions too: the tolerance of phase 5), and the sequence
    pseudo-labels written to the queue equal; the card's step must launch
    each kernel as :func:`_lm_launches` says.  An MoE path (DeepSeek-V2 at
    d_model 1024, see LM_TRAIN_PATHS) must route every MoE layer call's
    tokens to the same experts on both sides (the card's fp32 expert
    products take the per-expert loop, the CPU's the grouped products),
    and prints the smallest routing gap."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import init_train_state, make_train_step
    tag, _, _, cut, seq, _, _ = LM_TRAIN_PATHS[arch]
    base = cut(get_config(arch))
    cfg = replace(base, dtype="float32", semisfl=replace(
        base.semisfl, confidence_threshold=0.0))
    n = 2
    plan = _lm_plan(cfg, n, seq)
    batch = {k: v[0] for k, v in _lm_batches(cfg, 1, n, seq, seed=2).items()}
    step = make_train_step(plan, lr=0.02)
    # one step on the card first, so that the queue holds these sequences'
    # pseudo-labels and Eq. (5) has positives in the step compared
    t0 = time.perf_counter()
    state, _ = step(init_train_state(plan, seed=1, device="cuda"), batch)
    state_cpu, batch_cpu = _to_cpu(state), _to_cpu(batch)
    t_cpu = time.perf_counter()
    reset_launch_counts()
    (new_gpu, m_gpu), r_gpu = _with_routing(cfg, lambda: step(state, batch))
    torch.cuda.synchronize()
    counts = launch_counts()
    del state
    t_step = time.perf_counter()
    (new_cpu, m_cpu), r_cpu = _with_routing(
        cfg, lambda: step(state_cpu, batch_cpu))
    t_cmp = time.perf_counter()
    if r_cpu:
        same = [r["counts"] for r in r_gpu] == [r["counts"] for r in r_cpu]
        print(f"[cross-{tag}] routing on the CPU: {_routing_line(r_cpu)}; "
              f"the card's tokens per expert equal to the CPU's in every "
              f"layer call: {same}")
        if not same:
            fail(f"{arch} LM cross-check: the card routed tokens to other "
                 f"experts than the CPU")
    q_gpu, q_cpu = new_gpu.pop("queue"), new_cpu.pop("queue")
    errs = {k: abs(float(m_gpu[k]) - float(m_cpu[k])) for k in m_gpu}
    errs["queue.z"] = float((q_gpu.z.cpu() - q_cpu.z).abs().max())
    # each leaf compared on the card, the CPU's copied over (np.allclose's
    # test, |a - b| <= atol + rtol |b|)
    leaves = list(zip(_tensor_paths(new_gpu), _tensor_paths(new_cpu)))
    worst, worst_at = 0.0, ""
    for (path, a), (path_w, b) in leaves:
        if path != path_w or a.shape != b.shape:
            fail(f"{arch} LM cross-check: state leaves {path} "
                 f"{tuple(a.shape)} and {path_w} {tuple(b.shape)} do not "
                 "pair up")
        a, b = a.float(), b.to(a.device).float()
        e = float((a - b).abs().max())
        if e > worst:
            worst, worst_at = e, path
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            fail(f"{arch} LM cross-check: {path} differs card vs CPU by {e}")
    del a, b
    q_gpu, q_cpu = (convert.queue_to_numpy(q) for q in (q_gpu, q_cpu))
    print(f"[cross-{tag}] seconds: state and the queue-filling step on the "
          f"card, copy to the CPU {t_cpu - t0:.1f}; the step on the card "
          f"{t_step - t_cpu:.1f}; on the CPU {t_cmp - t_step:.1f}; the "
          f"comparison {time.perf_counter() - t_cmp:.1f}")
    print(f"[cross-{tag}] {arch} width {cfg.d_model}, {cfg.num_layers} "
          f"layers, fp32, {n} clients x 1 x {seq} tokens, one step: card vs "
          f"CPU metrics {', '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
          f" (loss {float(m_cpu['loss']):.6g}, clustering "
          f"{float(m_cpu['clustering']):.6g}); {len(leaves)} state leaves, "
          f"max|err| {worst:.3g} at {worst_at}; sequence pseudo-labels card "
          f"{q_gpu['label'][:n].tolist()} CPU {q_cpu['label'][:n].tolist()};"
          f" launches on the card {counts}; {time.perf_counter() - t0:.1f} s")
    if float(m_cpu["clustering"]) <= 0.0:
        fail(f"{arch} LM cross-check: Eq. (5) had no positive in the step "
             f"compared")
    if any(v > 1e-3 * max(1.0, abs(float(m_cpu.get(k, 0.0))))
           for k, v in errs.items()):
        fail(f"{arch} LM cross-check: metrics or queue features differ: "
             f"{errs}")
    for f in ("label", "conf", "valid"):
        if not np.array_equal(q_gpu[f], q_cpu[f]):
            fail(f"{arch} LM cross-check: the queue's {f} differs card vs "
                 f"CPU")
    if q_gpu["ptr"] != q_cpu["ptr"]:
        fail(f"{arch} LM cross-check: the queue pointers differ")
    for kernel, k_n in _lm_launches(cfg, n, None).items():
        if counts[kernel] != k_n:
            fail(f"{arch} LM cross-check: the card launched {kernel} "
                 f"{counts[kernel]} times, want {k_n}")


# the cut path whose graph phase is also fed by the prefetch worker
LM_PREFETCH_PATH = "h2o-danube-1.8b"


def _bitwise_diff(a, b) -> list:
    """The paths of the tensor leaves of two trees of the same structure
    (train states, metric dicts) that differ in a bit or in shape or
    dtype."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in tree for x in leaves(tree[k], f"{prefix}.{k}")]
        if isinstance(tree, (list, tuple)):
            names = getattr(tree, "_fields", range(len(tree)))
            return [x for k, t in zip(names, tree)
                    for x in leaves(t, f"{prefix}.{k}")]
        return [(prefix.lstrip("."), tree)]
    import torch
    bits = lambda t: t.contiguous().view(-1).view(torch.uint8)
    pa, pb = leaves(a), leaves(b)
    if [p for p, _ in pa] != [p for p, _ in pb]:
        return ["<structure>"]
    return [p for (p, x), (_, y) in zip(pa, pb)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(bits(x), bits(y))]


def phase_lm_graph(card: str, arch: str) -> None:
    """The captured, donated LM phase against the eager loop on the card:
    ``arch`` at full width, bf16, cut in depth as LM_TRAIN_PATHS cuts it
    for the card-vs-CPU step (danube 2 layers, xLSTM 4 blocks, Zamba2 4
    layers, Qwen2-VL 2 layers, Seamless 2 encoder layers and 1 decoder
    layer), the ``int8`` wire, tau 0, the path's rate, 4 clients x 4096
    positions (GRAPH_SEQ's where given), from one state (seed 1) and one
    batch draw (seed 3): K=3
    through ``make_train_phase`` (eager) from a clone, and through
    ``make_scanned_train_phase`` (graph, state donated), then 3 more steps
    each way from what came back.  Fails unless every state leaf and
    metric is equal bit for bit after each call, the kernels' launches a
    step are the same both ways (the graph's captured ones against a third
    of the eager call's), the donated phase returned the graph's static
    buffers both times, and the second graph call allocated nothing
    beyond its metrics.  On LM_PREFETCH_PATH also
    ``make_prefetched_train_phase`` over 2 phases of K=2 from host tokens
    against the scanned phase called on the same tokens in calls of K=1
    and K=3 (its graph's input stacks hold one step, so the second call
    replays in chunks), bit for bit, and no prefetch thread alive after
    it."""
    import threading

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.prefetch import THREAD_NAME
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import (init_train_state,
                                          make_prefetched_train_phase,
                                          make_scanned_train_phase,
                                          make_train_phase)
    from repro_torch.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    tag, _, lr, cut, _, _, _ = LM_TRAIN_PATHS[arch]
    base = cut(get_config(arch))
    cfg = replace(base, semisfl=replace(base.semisfl,
                                        confidence_threshold=0.0))
    seq = GRAPH_SEQ.get(arch, LM_SEQ)
    plan = _lm_plan(cfg, LM_CLIENTS, seq)
    tokens = _lm_batches(cfg, 6, LM_CLIENTS, seq, seed=3)
    part = lambda a, b: {k: v[a:b] for k, v in tokens.items()}
    clone = lambda st: tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, st)
    tensors = lambda st: [t for t in tree_leaves(st)
                          if isinstance(t, torch.Tensor)]
    state = init_train_state(plan, seed=1, device="cuda")

    eager = make_train_phase(plan, lr=lr, wire="int8")
    reset_launch_counts()
    e_state, e_m = eager(clone(state), part(0, 3))
    torch.cuda.synchronize()
    e_counts = {k: v for k, v in launch_counts().items() if v}
    e_state2, e_m2 = eager(e_state, part(3, 6))

    scanned = make_scanned_train_phase(plan, lr=lr, wire="int8")
    g_state, g_m = scanned(state, part(0, 3))
    (graph,) = scanned.graphs.values()
    static = [t for t in graph.static if isinstance(t, torch.Tensor)]
    adopted = all(a is b for a, b in zip(tensors(g_state), static))
    diffs = [_bitwise_diff(g_state, e_state), _bitwise_diff(g_m, e_m)]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    g_state2, g_m2 = scanned(g_state, part(3, 6))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    # the metrics are the call's only new tensors: 512-byte blocks
    metric_bytes = sum(-(-t.numel() * t.element_size() // 512) * 512
                       for t in g_m2.values())
    again = all(a is b for a, b in zip(tensors(g_state2), static))
    diffs += [_bitwise_diff(g_state2, e_state2), _bitwise_diff(g_m2, e_m2)]
    per_step = {k: v / 3 for k, v in e_counts.items()}
    captured = {k: v for k, v in graph.launches.items() if v}
    print(f"[{tag}-graph] {arch} width {cfg.d_model}, {cfg.num_layers} "
          f"layers, bf16, int8, {LM_CLIENTS} x {seq} tokens, 2 calls of "
          f"K=3: graph against eager, leaves and metrics differing "
          f"{[len(d) for d in diffs]} (state, metrics; each call) of "
          f"{len(tensors(g_state))} state leaves; launches a step eager "
          f"{per_step}, captured {captured}; the donated phase returned its "
          f"static buffers {adopted} and {again}, the second call grew "
          f"allocated memory by {grown} B (its metrics {metric_bytes} B); "
          f"capture {graph.capture_s:.4f} s; on {card}")
    if any(diffs):
        fail(f"{arch}: the graph's K=3 phases differ from the eager loop's "
             f"at {[d[:4] for d in diffs]}")
    if per_step != captured:
        fail(f"{arch}: launches a step differ, eager {per_step}, graph "
             f"{captured}")
    if not (adopted and again and len(static) == len(tensors(state))):
        fail(f"{arch}: the donated phase did not return its static buffers")
    if grown > metric_bytes:
        fail(f"{arch}: a donated K=3 call on its own state allocated "
             f"{grown} B, its metrics {metric_bytes} B")
    del e_state, e_state2, g_state, g_state2, state, scanned, graph, static

    if arch == LM_PREFETCH_PATH:
        # the reference's second call (K=3) replays a K_cap-1 graph in 3
        # chunks
        host = [{k: v.cpu().numpy() for k, v in part(a, a + 2).items()}
                for a in (0, 2)]
        ref_phase = make_scanned_train_phase(plan, lr=lr, wire="int8")
        s_ref = init_train_state(plan, seed=1, device="cuda")
        m_ref = []
        for a, b in ((0, 1), (1, 4)):
            s_ref, m = ref_phase(s_ref, part(a, b))
            m_ref.append(m)
        m_ref = {k: torch.cat([m[k] for m in m_ref]) for k in m_ref[0]}
        run = make_prefetched_train_phase(plan, lr=lr, wire="int8")
        s_pf, m_pf = run(init_train_state(plan, seed=1, device="cuda"),
                         [lambda h=h: h for h in host])
        torch.cuda.synchronize()
        alive = [t.name for t in threading.enumerate()
                 if t.name == THREAD_NAME]
        pdiff = [_bitwise_diff(s_pf, s_ref), _bitwise_diff(
            {k: torch.cat([m[k] for m in m_pf]) for k in m_ref}, m_ref)]
        print(f"[{tag}-graph] prefetched phase, 2 phases of K=2 from host "
              f"tokens, against the scanned phase in calls of K=1 and K=3: "
              f"leaves and metrics differing {[len(d) for d in pdiff]}; "
              f"prefetch threads alive after it {alive}; on {card}")
        if any(pdiff) or len(m_pf) != 2:
            fail(f"{arch}: the prefetched phase differs from the scanned "
                 f"one at {[d[:4] for d in pdiff]}")
        if alive:
            fail(f"{arch}: a prefetch thread outlived its phase: {alive}")
        del s_ref, s_pf, ref_phase, run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}-graph] {time.perf_counter() - t_phase:.1f} s")


def _tensor_paths(tree, prefix: str = "") -> list:
    """(path, tensor) of a port tree's tensor leaves, in order."""
    import torch
    if isinstance(tree, dict):
        return [x for k in tree for x in _tensor_paths(tree[k],
                                                       f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _tensor_paths(t, f"{prefix}[{i}]")]
    return ([(prefix.lstrip("."), tree)] if isinstance(tree, torch.Tensor)
            else [])


def _paths(tree, prefix: str = "") -> list:
    """(path, leaf) of a tree of dicts and lists of numpy arrays, in order;
    a None (an empty layer segment, a DeepSeek bottom's ``stack``) has
    none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _paths(t, f"{prefix}[{i}]")]
    return [(prefix.lstrip("."), np.asarray(tree))]


KERNEL_META = {
    "clustering_fwd": ("src/repro_torch/csrc/clustering_loss.cu",
                       "src/repro/kernels/clustering_loss.py:140"),
    "clustering_bwd": ("src/repro_torch/csrc/clustering_loss.cu",
                       "src/repro/kernels/clustering_loss.py:184"),
    "quantize_fused": ("src/repro_torch/csrc/quantize.cu",
                       "src/repro/kernels/quantize.py:74"),
    "quantize_amax": ("src/repro_torch/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:74"),
    "quantize_qdq": ("src/repro_torch/csrc/quantize.cu",
                     "src/repro/kernels/quantize.py:88"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:105"),
    # no Pallas kernel has a backward: the JAX model trains through the VJP
    # of its jnp stand-in for the flash kernel
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:74"),
    "slstm_scan": ("src/repro_torch/csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan.py:77"),
    # as flash's backward: the JAX model trains through the VJP of its
    # lax.scan over slstm_step
    "slstm_scan_bwd": ("src/repro_torch/csrc/slstm_scan_bwd.cu",
                       "src/repro/models/xlstm.py:241"),
    "mamba2_scan": ("src/repro_torch/csrc/mamba2_scan.cu",
                    "src/repro/kernels/mamba2_scan.py:88"),
    # as flash's backward: the JAX model trains through the VJP of its jnp
    # stand-in for the Mamba2 kernel, ssd_chunked
    "mamba2_scan_bwd": ("src/repro_torch/csrc/mamba2_scan_bwd.cu",
                        "src/repro/models/ssm.py:79"),
    # its mma route (mamba2_bwd_cb, mamba2_scan_bwd_mma_kernel,
    # mamba2_bwd_epilogue): the bf16 calls, all of the training path's
    "mamba2_scan_bwd_mma": ("src/repro_torch/csrc/mamba2_scan_bwd.cu",
                            "src/repro/models/ssm.py:79"),
}
# the main path's kernels; the quantizer's two-pass ones run on the
# paper-vgg13 rounds instead
TRAIN_KERNELS = ("clustering_fwd", "clustering_bwd", "quantize_fused")
TWO_PASS_KERNELS = ("quantize_amax", "quantize_qdq")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    last = [t0]

    def lap(what: str) -> None:
        # the phase's seconds, and what it left on the card once its dead
        # objects are gone
        now = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[clock] {what} done at {now - t0:.1f} s ({now - last[0]:.1f}"
              f" s); {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
              f"allocated, {torch.cuda.memory_reserved() / 2 ** 30:.3f} "
              f"GiB reserved")
        last[0] = time.perf_counter()
    card = phase_device()
    ptxas = phase_build()
    lap("build")
    checked = phase_kernels(card, ptxas.get("clustering_loss", ""))
    flash = phase_flash(card)
    checked["errs"]["flash_attention"] = flash["err"]
    checked["timings"]["flash_attention"] = flash["timing"]
    flash_bwd = phase_flash_bwd(card, ptxas.get("flash_attention_bwd", ""))
    checked["errs"]["flash_attention_bwd"] = flash_bwd["err"]
    checked["timings"]["flash_attention_bwd"] = flash_bwd["timing"]
    slstm = phase_slstm(card, ptxas.get("slstm_scan", ""))
    checked["errs"]["slstm_scan"] = slstm["err"]
    checked["timings"]["slstm_scan"] = slstm["timing"]
    slstm_bwd = phase_slstm_bwd(card, ptxas.get("slstm_scan_bwd", ""))
    checked["errs"]["slstm_scan_bwd"] = slstm_bwd["err"]
    checked["timings"]["slstm_scan_bwd"] = slstm_bwd["timing"]
    mamba2 = phase_mamba2(card, ptxas.get("mamba2_scan", ""))
    checked["errs"]["mamba2_scan"] = mamba2["err"]
    checked["timings"]["mamba2_scan"] = mamba2["timing"]
    mamba2_bwd = phase_mamba2_bwd(card, ptxas.get("mamba2_scan_bwd", ""))
    checked["errs"]["mamba2_scan_bwd"] = mamba2_bwd["err"]
    checked["timings"]["mamba2_scan_bwd"] = mamba2_bwd["timing"]
    checked["errs"]["mamba2_scan_bwd_mma"] = mamba2_bwd["err"]
    checked["timings"]["mamba2_scan_bwd_mma"] = mamba2_bwd["timing"]
    lap("kernel checks")

    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    runs = phase_main_path(card)
    launches = launch_counts()
    print(f"[main] kernel launches on the main path: {launches}")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        fail(f"the main path never launched {missing}")
    if any(launches[k] for k in TWO_PASS_KERNELS):
        fail(f"the main path's cut tensors took the two-pass route: "
             f"{launches}")
    vgg = phase_vgg(card)
    for kernel in TWO_PASS_KERNELS:
        launches[kernel] = vgg[kernel]
    trained, system = runs["int8+topk0.05"]
    phase_cross_check(runs["fp32"][0], system)
    phase_profile(card, trained)
    del runs, system
    lap("training path")
    baseline_runs = phase_baselines(card, trained)
    phase_baseline_cross_check(baseline_runs)
    del baseline_runs
    lap("baselines")
    phase_models(card)
    lap("paper-alexnet and paper-vgg16")
    phase_checkpoints(card)
    torch.cuda.empty_cache()
    lap("checkpoints")
    phase_executors(card, trained)
    del trained
    lap("round executors")

    # each serving path reads its own counts, set to 0 just before it; a
    # kernel that runs on two paths (flash attention: Qwen3-14B, Zamba2-7B)
    # is listed with its count from the first
    for arch, (kernels, *_) in SERVE_PATHS.items():
        counts = phase_serve(card, arch)
        for kernel in kernels:
            launches[kernel] = launches[kernel] or counts[kernel]
        phase_serve_profile(card, arch)
        phase_serve_cross_check(arch)
        lap(f"{arch} serving path")

    # each LM training path reads its own counts (set to 0 inside, just
    # before its steps); a kernel already counted on a serving path (flash
    # attention, the sLSTM scan) keeps that count
    for arch in LM_TRAIN_PATHS:
        lm = phase_lm_train(card, arch)
        for kernel, n in lm.items():
            launches[kernel] = launches[kernel] or n
        phase_lm_cross_check(arch)
        phase_lm_graph(card, arch)
        lap(f"{arch} training path")

    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        t = checked["timings"][name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": checked["errs"][name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"]})
        # no time is below its bound, bar a bytes bound that the L2 can
        # beat (inputs under 4x its size may be read warm)
        warm = (t["bound"][1] == "bytes"
                and t["bound"][0] * 1e-3 * PEAK_BYTES < 4 * l2_bytes())
        if t["ms"] < t["bound"][0] and not warm:
            fail(f"{name}: {t['ms']} ms a call is below its bound of "
                 f"{t['bound'][0]} ms: a lost profiler record?")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
