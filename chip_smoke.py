"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase is caught):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every CUDA kernel of the serving paths from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (sm_90a; one ``nvcc`` per source, all
   started together), timed, with ptxas's register and spill report and
   each flash-attention instantiation's tensor-core (``HMMA``) and f32 FMA
   instruction counts from ``cuobjdump -sass``: every bf16 instantiation
   must hold ``HMMA``;
3. hold the paged decode kernel (a cluster of blocks per slot and KV head,
   each on a share of the slot's positions, merged through distributed
   shared memory) against its plain PyTorch version at the serving path's
   shapes (bf16) and at a small f32 shape — dead slots, tail pages and
   aliased pages included — and time both with CUDA events;
4. serve full-width ``smollm-360m`` (random weights from a fixed
   ``torch.Generator``) through the paged ``ServeEngine``: 16 seeded
   requests, prompts of 17–300 tokens (two share a 128-token prefix),
   ``max_new`` 32, ``max_batch`` 8, ``block_size`` 16, and a pool tight
   enough to force preemption. The decode kernel's launch count must equal
   ``n_layers`` x the decode steps run, and the flash-attention kernel's
   ``n_layers`` x the prefills;
5. replay the served streams teacher-forced through the kernel and through
   the plain attention, and compare the per-step logits;
6. profile one more short drain with ``torch.profiler``: the card's busy
   share of the wall time and the kernels that took it; the trace must
   show the decode and flash kernels as often as their wrappers counted,
   and the other kernels not at all. The trace window opens with a burst
   of sacrificial kernels and closes after idle time, since the profiler
   can drop a window's earliest and latest records (every profiled drain:
   phases 6, 7b, 10 and 11);
7. speculative decoding: (a) hold the verify-window kernel (the decode
   kernel's cluster body at Q rows) against its plain version at the
   speculative path's shapes (bf16, windows crossing
   a page, a dead slot, rows past the table's coverage, aliased pages), at
   a small f32 shape, and at a window of one against the decode kernel,
   and time it; (b) serve the phase-4 workload through
   ``ServeEngine(speculate=SpecConfig(...))`` on a target whose layers past
   the first two are damped (as a trained model's later layers refine
   rather than overturn its early ones) with its own first two layers as
   the draft, k = 3, beside a non-speculative drain of the same target.
   The window kernel's launch count must equal ``n_layers`` x the verify
   rounds run (the flash kernel's, one per layer per target and draft
   prefill), the decode kernel must not launch, and some rounds must
   accept every draft and some not. Streams that differ from the
   non-speculative ones are replayed teacher-forced through the window
   kernel and through the plain attention. A profiled speculative drain
   must show the window and flash kernels as often as their wrappers
   counted, and the decode kernel not at all;
8. hold the flash-attention kernel (bf16 on the tensor cores, ``mma.sync``
   with P split into two bf16 terms; f32 on the CUDA cores) against its
   plain version at both prefill shapes — (a) recurrentgemma-2b's: 10 query heads over one KV
   head, Dh 256, a 2 300-token prompt, window 2 048; (b) smollm-360m's: 15
   over 5, Dh 64, 300 tokens, causal — and at edge cases (a tail tile, S
   below one tile, window 1, non-causal, f32); time each beside the plain
   version and one ``scaled_dot_product_attention`` call, the library
   yardstick, which is held to the plain version too (and, where a window
   bites, shown to fail that limit without its window mask);
9. hold the RG-LRU scan kernel against its plain version at ``[1, 2 300,
   2 560]`` in bf16 and f32 and at an odd length, and time each;
10. serve full-width ``recurrentgemma-2b`` (random bf16 weights from a fixed
   ``torch.Generator``) through ``ServeEngine(mode="continuous")``: 8
   seeded requests, 7 of 17–400 tokens and one of 2 300, past the local
   window, ``max_new`` 16, ``max_batch`` 4, ``capacity`` 2 400. Each
   prefill must launch the flash kernel once per attention layer (8) and
   the scan once per recurrent layer (18), and nothing else. The streams
   are replayed teacher-forced with both kernels and with both plain
   versions, and a profiled drain must show both kernels under their own
   names as often as their wrappers counted;
11. (a) hold the WKV scan kernel against its plain version at
   ``rwkv6-1.6b``'s prefill shape (B 1, a 2 300-token prompt, 32 heads of
   64) with bf16 and f32 inputs, at its decode step (B 4, S 1, from a
   nonzero state), at Dh 128 with S 37, and through strided views, and time
   each; scan the bf16 prefill as 2 299 steps and one decode step from
   their state, which must give the whole scan's y and final state bit for
   bit; then serve full-width ``rwkv6-1.6b`` (random bf16 weights from a
   fixed ``torch.Generator``) through ``ServeEngine(mode="continuous")`` on
   phase 10's workload. Every prefill and every decode step must launch the
   WKV kernel once per layer (24), and the plain WKV recurrence must not run.
   The streams are replayed teacher-forced, and every layer's WKV output is
   held in f32 to the plain version's under a stated error model whose
   limit has at least twice the measured rounding noise (plain version vs
   f64); a profiled drain must show the kernel as often as its wrapper
   counted;
12. the paper's decentralized bilevel run (``repro_torch.core``), which
   runs no TPU kernel and so adds none: the §6 logistic-regression
   hyperparameter workload as the JAX package's benchmarks build it
   (a9a-syn 8 000 x 123 split 70/30, ``ring(8)``, 50 samples per node,
   J = 10 with randomized truncation, the paper's step sizes). (a) fig1:
   DSBO, GDSBO, MDBO and VRDBO, 60 steps each, fused: one CUDA graph
   capture and six replays, and the upper loss must fall; (b) MDBO and
   VRDBO per_step against fused, bit for bit, on the dense and
   ``ring_rolled`` mixes; (c) the card against the port's CPU run on the
   same batches and J̃, within a stated f32 limit; (e) MDBO at K = 16, and
   through the device sampler on (a)'s cached graph. Prints steps/s of
   both dispatches and the card's busy share over one 10-step chunk of
   each;
13. the decentralized bilevel LM trainer (``repro_torch.train``), which
   runs no TPU kernel and so adds none, on full-width ``smollm-360m``
   (random f32 weights from seed 0): (a) ``repro_torch.launch.train.main``
   at its defaults (MDBO, the ring mix, K = 4, per-node batch 2 x 32
   tokens, J = 2 randomized) for 10 steps, fused: one CUDA graph capture
   and two replays, every eval's losses finite; steps/s, tokens/s, the
   capture's seconds and the peak memory; (b) the same run per_step for 5
   steps, every state leaf bit for bit equal to the fused run's; (c) the
   reduced config (f32) of each of the seven trained architectures
   (smollm-360m, recurrentgemma-2b, rwkv6-1.6b, phi3.5-moe, grok-1,
   chameleon-34b, whisper-tiny), MDBO and VRDBO, fused on the card against
   per_step on the port's CPU on the same batches and J̃ within a stated f32
   limit, and a reduced CLI run whose checkpoints ``restore`` gives back;
   (d) the card's busy share over the per_step chunk and one replayed
   fused chunk;
14. compressed and asynchronous gossip (``core/compression.py``,
   ``core/async_gossip.py``, the Engine's stateful-mix carry,
   ``repro_torch.obs``), which run no TPU kernel and so add none, on phase
   12's workload: (a) ``fig_compression.py``'s grid, MDBO at K = 8, 40 steps
   fused through the device sampler, on the dense mix and on
   ``compressed_topk`` at 0.25 and 0.05, plain and EF21 (one capture and
   two replays each): the final loss, consensus and y bytes per round;
   (b) ``async_bench.py``: ``ring_rolled`` against ``async_gossip`` at
   τ 3 under the straggler delay model at a 4 ms deadline and at the
   adaptive 0.90-quantile one, with a live ``Recorder``: the realized
   staleness histogram beside ``expected_staleness``, simulated time to
   the worst final loss, steps/s; (c) per_step against fused, bit for bit
   with every mix slot, for MDBO and VRDBO on EF21 top-k, the EF21 random
   mask and async gossip, and async τ 0 against ``ring_rolled``; (d) MDBO's
   card runs against the port's CPU run on the same batches, J̃ and
   deliveries; (e) a reduced LM config through ``make_trainer_engine`` on
   EF21 top-k and on async gossip, fused against per_step and the peak
   memory, and the full-width memory arithmetic from phase 13's numbers;
15. the dense configs of the eighth slice at their published widths
   (random bf16 weights from seed 0, one model on the card at a time) and
   the rest of the serving engine. First the kernels at the shapes these
   configs hand them, each against its plain version and timed: paged
   decode at qwen2.5-3b's heads (16 over 2 of 128) and granite-8b's (32
   over 8), qwen's verify window at k 3, flash attention at the cohort
   drain's batch-4 prefill, the sliding-window prefill (4 500 tokens,
   window 4 096) and minicpm-2b's bucketed prefill (36 heads of 64), with
   the library yardstick. (a) qwen2.5-3b (QKV biases drawn from the seed)
   on phase 4's generator cut to 8 requests, ``max_new`` 16, 4 slots:
   the cohort drain (two left-padded cohorts, one flash launch per layer
   per cohort) replayed teacher-forced through the flash kernel and the
   plain attention; the paged drain on a pool that forces preemption, on
   the kernel read path with a live ``Recorder`` (8 finished, 8 TTFT and
   latency observations, TTFT p50 and max printed beside tokens/s), on
   the reference read path (no decode kernel) and with pow2 prefill
   buckets, each stream equal to the kernel drain's or a bf16 near-tie
   under a plain replay; speculative decoding on a target damped past
   layer 2 with its first 2 layers as the draft, k 3, at ``rounds`` 1 and
   the default, against the plain drain of that target; the serving CLI's
   ``--mode cohort --metrics`` (reduced widths). (d) qwen's ``long_500k``
   variant in continuous mode at capacity 4 096 on one 4 500-token prompt.
   (b) granite-8b, a paged kernel drain of 4 requests. (c) minicpm-2b, a
   continuous drain with prefill buckets. Every drain's launches are
   checked and its streams replayed teacher-forced; the kernel rows print
   as one ``[15 rows]`` JSON line.
16. the moe, vlm and audio families of the ninth slice at their published
   widths (random bf16 weights from seed 0), the depth cut only where one
   80 GB card forces it and printed beside each config: phi3.5-moe 8 of 32
   layers, grok-1 2 of 64, chameleon-34b 16 of 48, whisper-tiny whole. First
   the kernels at the shapes these configs hand them, each against its
   plain version and timed: flash attention at whisper's encoder (1 500
   frames, full) and cross-attention (300 x 1 500, full), at phi's prefill
   (32 heads over 8 of 128) and chameleon's (64 over 8, 1 300 tokens), with
   the library yardstick; paged decode at phi's and chameleon's heads, and
   chameleon's verify window at k 8 (Q 9 x G 8 = 72 rows, two of the
   repaired kernel's row tiles). (a) phi3.5-moe on phase 15's 8 requests,
   ``max_new`` 16, 4 slots: continuous (against the drain one request at a
   time), paged on the kernel and the reference read paths (no shared
   prefixes: an MoE prefill's K/V depend on the whole prompt), speculative
   on the damped target with its first 2 layers as the draft, k 3; every
   per-token MoE routing of a decode step, a verify row or a draft step
   must drop nothing (C = 4 >= K), and the count is printed. (b) grok-1, a
   continuous drain of 4 requests, every logit within the soft-cap. (c)
   chameleon-34b, 4 requests of 1 100-1 400 tokens (past its 1 024 image
   positions): paged, continuous, speculative at k 8. (d) whisper-tiny, 8
   requests: continuous (against one request at a time) and the cohort
   drain. Every drain's launches are checked and its streams replayed
   teacher-forced through the kernels and their plain versions, batched as
   the engine batched them; for the moe family the plain replay takes the
   kernel replay's routing, and every routing it would have chosen
   otherwise must be a near-tie. phi's paged kernel engine, chameleon's and
   whisper's continuous one each serve one more drain under the profiler
   (phase 6's): the busy share, each kernel traced as often as counted.
   Tokens/s, the peak memory and the weights' size print per config; the
   kernel rows print as one ``[16 rows]`` JSON line.
17. the LM trainer on full-width ``whisper-tiny`` (the audio family: the
   encoder over 1 500 frames of the audio stub, cross-attention, vocab
   51 865; random f32 weights from seed 0), which runs no TPU kernel and
   so adds none, through ``repro_torch.launch.train.main``: MDBO, K = 4,
   phase 13's per-node batch of 2 x 32 tokens and its step counts; per_step
   for 5 steps, then fused for 10 (one capture, two replays); the fused
   state after 5 steps equal to the per_step one leaf for leaf, bit for
   bit, and the evals at steps 0 and 5 finite and equal; steps/s of both
   dispatches, the peak memory and the card's busy share over one replayed
   chunk;
18. the dry run on the card's roofline (``repro_torch.launch.dryrun``),
   which runs no TPU kernel and so adds none: the trainer's step traced on
   ``meta`` tensors on the one-card mesh, in a worker process started
   before phase 2, at (a) phase 13's workload (full-width ``smollm-360m``,
   MDBO, K = 4, 2 x 32 tokens a node, J = 2) and (b) phase 17's
   (full-width ``whisper-tiny``), each held against the same step on the
   card: the state's, step batch's and J̃'s bytes equal to the dry run's
   ``argument_bytes``, a ``FlopCounterMode`` count of one per_step step
   equal to its flops and within 10 % of K x (9 + 9 J) forwards of a node,
   each forward's count equal to its matrix products summed by hand
   (``forward_flops``), the card's peak over that step within 15 % of the
   predicted peak, and the median of five replays of a one-step CUDA graph
   no faster than ``t_compute``; prints ``t_compute``, ``t_memory``, the
   bound and bound / measured. (c) ``repro_torch.optim``'s ``adamw`` after
   ``clip_by_global_norm`` for 5 steps on a card tree against its CPU
   copy, within 1e-6 relative.

Prints a ``{"kernels": [...]}`` line naming all five kernels, then the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``. Needs a CUDA card
and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

ARCH = "smollm-360m"
SEED = 0
N_REQUESTS, MAX_NEW, MAX_BATCH = 16, 32, 8
BLOCK_SIZE, DECODE_CHUNK = 16, 8
PROMPT_LENS = (17, 300)
SHARED_PREFIX = 128
CAPACITY = 336          # 21 blocks: the longest prompt plus 32 new tokens
NUM_BLOCKS = 72         # less than 8 slots' prompts need: forces preemption
# csrc/<name>.cu, one nvcc each, all started together
KERNEL_SOURCES = ("paged_attention", "flash_attention", "rglru_scan",
                  "wkv6_scan")
# each kernel wrapper's __global__ function, as a profiler trace names it
KERNEL_SYMBOLS = {"paged_attention": "paged_attention_decode_kernel",
                  "paged_attention_multi": "paged_attention_multi_kernel",
                  "flash_attention": "flash_attention_kernel",
                  "rglru_scan": "rglru_scan_kernel",
                  "wkv6_scan": "wkv6_scan_kernel"}
# The profiled drains' trace window. In a window after a process's first,
# the profiler can drop the earliest device records as lying outside the
# window ("Out-of-range" in its log), however long the window has been open
# before them: none, one, or hundreds (1 to 643 in this script's windows
# on the H100). It drops the latest ones by time: a window that closed on
# the drain's last kernel lost 13, then 5, of its 576 WKV launches, while
# with 0.2-0.5 s of idle time after the drain every drain was kept (a burst
# of spins after that idle time lost 0 to all 2 000 of its records). So
# each window opens with a burst of TRACE_BURST sacrificial spin kernels
# (torch.cuda._sleep), run to their end before the drain starts, which the
# early drops eat into (how far is reported), and closes with TRACE_TAIL_S
# of idle time, which the late drops eat into. The check itself is that
# the trace shows every kernel exactly as often as its wrapper counted.
TRACE_BURST, TRACE_TAIL_S, TRACE_SPIN = 2000, 0.5, "spin_kernel"
# phase 7: truncated self-speculation. The target's layers past the first
# SPEC_DRAFT_LAYERS are scaled by SPEC_DAMP (the JAX package's serving
# benchmark builds its speculative pair the same way) and the draft is the
# target's own first SPEC_DRAFT_LAYERS layers.
SPEC_K, SPEC_DRAFT_LAYERS, SPEC_DAMP = 3, 2, 0.05

# Kernel vs plain version. f32: the same f32 softmax, summed in another
# order (a few ulp). bf16: both accumulate in f32 and round the output to
# bf16 once, so an element can differ by one bf16 ulp, at most 2**-7 of
# |plain|. The limit is two such ulps of each element, plus BF16_ATOL for
# outputs near zero, where the f32 sums' order shows: ~1.7e-3 at the
# |out| ~ 0.1 of these inputs, below the ~1e-2 one wrongly masked position
# on a long slot would cost.
TOL_F32 = 2e-5
BF16_RTOL, BF16_ATOL = 2 ** -6, 1e-4
# Teacher-forced replay, kernel vs plain attention: per step the two paths
# differ by at most an ulp of each attention output (above), and 32 bf16
# residual layers carry that into the logits (|logit| ~ 4 at this init,
# where one bf16 ulp is 2**-6). The limit is 16 such ulps. The hybrid
# replay (phase 10) holds recurrentgemma-2b's 26 layers to the same limit:
# its logits are of the same size (tied embeddings at d_model**-0.5), and
# the scan's f32 carry departs from the plain bf16 carry by about an ulp of
# h, since the decays a = u**(8 r), u in [0.43, 0.85], keep the recurrence's
# memory to a few steps.
TOL_REPLAY = 0.25
# An MoE routing of a replay through the plain attention that differs from
# the kernel replay's it is pinned to (chip_smoke.pinned_routing) must be a
# near-tie: its own experts may hold at most this much more router weight,
# relative, than the pinned ones. Both replays' hidden states differ by a
# few bf16 ulps (2**-8 relative each) through the layers, which moves a
# router probability by about that much; 2**-5 is a few times it, and far
# below the ~0.1-0.3 that separates the k-th and (k+1)-th experts of a
# typical token.
MOE_TIE = 2 ** -5

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak and
# the f32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# phases 8-10: continuous serving of full-width recurrentgemma-2b, whose
# prefill runs the flash-attention and RG-LRU kernels. One prompt is longer
# than the 2 048-position local window, so the window mask bites and the
# prefill's ring of K/V is rolled.
HYBRID_ARCH = "recurrentgemma-2b"
HYB_REQUESTS, HYB_MAX_NEW, HYB_MAX_BATCH = 8, 16, 4
HYB_PROMPT_LENS = (17, 400)
HYB_LONG_PROMPT = 2300
HYB_CAPACITY = 2400     # rings of min(2 400, local_window 2 048) positions
# RG-LRU scan, bf16: the kernel carries h in f32, the plain version in bf16;
# the limit is the JAX package's own for a bf16 recurrence against its f32
# carry (tests/test_kernels.py:104). The kernel must also equal, bit for
# bit, the plain version run on the inputs widened to f32 and rounded once.
TOL_RGLRU_BF16 = 5e-2
# The library yardstick against the plain version, bf16: its kernels round
# the (unnormalised) probabilities to bf16, unit roundoff 2**-8, before the
# PV product, so an output moves by at most 2**-8 sum_j p_j |v_j| beyond
# the kernel's own limit (both round the output once). The limit is twice
# that: the kernel's limit plus LIB_P_RTOL times the plain attention of
# |v|, ~6e-3 at the rows of shape (a) that average ~2 000 keys. Phase 8
# checks that a library call without the window mask fails it.
LIB_P_RTOL = 2 ** -7

# phase 11: continuous serving of full-width rwkv6-1.6b, every WKV
# recurrence of its prefill and decode on the wkv6_scan kernel, on the
# workload of phase 10
SSM_ARCH = "rwkv6-1.6b"
# WKV scan, kernel vs plain version (phase 11a). Both carry the state in f32
# and round its update the same way, so the final states must be equal bit
# for bit. y: both compute each column's Dh-term dot product in f32, summed
# in other orders, so each rounding moves y by at most 2**-24 of one term;
# M, the recurrence run on |inputs|, bounds the terms' summed magnitude.
# The limit adds 16 such units of M to the file's limits: TOL_F32 +
# WKV_UNITS M in f32, BF16_ATOL + BF16_RTOL |plain| + WKV_UNITS M when y is
# rounded to bf16.
WKV_UNITS = 16 * 2 ** -24
# The teacher-forced replay (phase 11) compares each layer's WKV output y in
# f32, kernel against plain version, on the kernel path's own inputs, under
# the same error model and limit: the final states must be equal bit for
# bit, so the two y differ only by their dot products' order, within
# WKV_UNITS M element by element. The plain version against the same
# recurrence in f64 is the rounding noise, which must stay within half that
# limit (2x headroom).

# phase 12: the paper's decentralized bilevel run, the §6 workload as the
# JAX package's benchmarks build it (benchmarks/common.py, ``build``):
# a9a-syn (8 000 x 123, 2 classes, seed 0) split 70/30, ring(8), batch
# 400 / K per node, logreg_hyperopt(d=123, lip_gy=5), J = 10 with the
# paper's randomized truncation, and the paper's step sizes (PAPER_HP,
# copied: the smoke run imports nothing of the benchmarks)
BL_N, BL_D, BL_K, BL_BATCH_TOTAL, BL_J, BL_LIP = 8_000, 123, 8, 400, 10, 5.0
BL_HP = {"dsbo": (0.1, 1.0, 1.0, 1.0, 1.0), "gdsbo": (0.1, 1.0, 1.0, 1.0, 1.0),
         "mdbo": (0.1, 1.0, 1.0, 1.0, 1.0), "vrdbo": (0.33, 5.0, 5.0, 1.0, 1.0)}
BL_FIG1_STEPS, BL_EVAL = 60, 10   # fig1_loss_curves.py's run
BL_STEPS = 20                     # the dispatch, CPU and K = 16 checks
# The card against the port's own CPU run (TF32 off): the same f32 ops on
# the same batches and J̃, summed in other orders by other libraries, so
# each step moves by a few f32 ulps, which 20 steps of contracting updates
# carry without growth. The limits are on the losses and on max |x|, |y|
# differences, ~1e3 x the f32 unit roundoff at these magnitudes.
TOL_BL_LOSS, TOL_BL_PARAM = 1e-4, 1e-4


# phase 13: the decentralized bilevel LM trainer through its CLI at the CLI's
# defaults — MDBO on the ring mix, K = 4 nodes, a per-node batch of 2 x 32
# tokens, J = 2 with randomized truncation, seed 0 — on full-width
# smollm-360m (random f32 weights, bf16 compute), 10 steps in fused chunks
# of 5 (one capture, two replays)
TR_ARCH, TR_K, TR_BATCH, TR_SEQ, TR_STEPS, TR_EVAL = (
    "smollm-360m", 4, 2, 32, 10, 5)
TR_ARGV = ["--arch", TR_ARCH, "--steps", str(TR_STEPS), "--eval-every",
           str(TR_EVAL)]
# (c): the reduced configs (f32) on the card against the port's CPU run on
# the same batches and J̃: the same f32 ops summed in other orders, a few
# ulps a step, which three steps of contracting updates carry without
# growth; the limit is on the losses and on max |difference| of every state
# leaf (all O(1) or smaller), as phase 12's
TR_SMALL_K, TR_SMALL_SEQ, TR_SMALL_STEPS, TOL_TR = 2, 16, 3, 1e-4
TR_FAMILIES = ("smollm-360m", "recurrentgemma-2b", "rwkv6-1.6b",
               "phi3.5-moe-42b-a6.6b", "grok-1-314b", "chameleon-34b",
               "whisper-tiny")


# phase 14: compressed and asynchronous gossip on phase 12's workload.
# (a) fig_compression.py's grid: MDBO, K = 8, 40 steps fused in chunks of
# 20, through the device sampler, on the dense mix and on compressed_topk at
# each ratio, plain and EF21
GS_STEPS, GS_EVAL, GS_RATIOS = 40, 20, (0.25, 0.05)
# (b) async_bench.py: ring_rolled against async_gossip at tau 3 under the
# straggler model (2 ms links, 15 % of them Exp(30 ms) late) at a 4 ms
# deadline and at the 0.90-quantile adaptive one, 60 steps in chunks of 6,
# each run once to capture and once timed
AS_STEPS, AS_EVAL, AS_TAU, AS_DEADLINE_S, AS_Q = 60, 6, 3, 4e-3, 0.90
AS_DELAY = {"base_s": 2e-3, "straggler_prob": 0.15,
            "straggler_scale_s": 30e-3}
# (c), (d): per_step against fused and the card against the CPU, 6 steps in
# chunks of 3, MDBO and VRDBO, the limits of phase 12 (c) (the same f32
# ops in other orders; top-k's gaps at 123 features are far wider)
GS_CHECK_STEPS, GS_CHECK_EVAL = 6, 3
# (e): a reduced LM config through make_trainer_engine, K = 4
GS_TR_K, GS_TR_STEPS, GS_TR_EVAL = 4, 4, 2

# phase 15: the dense configs of the port's eighth slice at their published
# widths (random bf16 weights from seed 0). qwen2.5-3b serves phase 4's
# prompt generator cut to 8 requests (two share a 128-token prefix), 16
# new tokens each, 4 slots, capacity 512, blocks of 16; its QKV biases get
# QW_BIAS x a normal draw from seed SEED + 15, since the JAX initialiser
# zeroes them. QW_NUM_BLOCKS is less than the first four prompts and their
# budgets need, which forces preemption (requests 1 and 3 are never
# resident together at this pool size, so no prefix is shared).
QW_ARCH, GR_ARCH, MC_ARCH = "qwen2.5-3b", "granite-8b", "minicpm-2b"
QW_REQUESTS, QW_MAX_NEW, QW_MAX_BATCH, QW_CAPACITY = 8, 16, 4, 512
QW_NUM_BLOCKS, QW_BIAS = 40, 0.1
# granite-8b: a paged kernel drain of the first 4 requests (default pool);
# minicpm-2b: a continuous drain of all 8 with pow2 prefill buckets
GR_REQUESTS = 4
# qwen2.5-3b's long_500k variant (window 4 096) in continuous mode at a
# capacity of one window: one prompt past it, so the prefill's window
# bites, its ring is rolled and decode wraps it
SWA_SHAPE, SWA_CAPACITY, SWA_PROMPT, SWA_MAX_NEW = "long_500k", 4096, 4500, 8

# phase 16: the moe, vlm and audio families of the ninth slice at their
# published widths (random bf16 weights from seed 0), the depth cut only
# where one 80 GB card forces it: phi3.5-moe 8 of 32 layers (the whole is
# ~84 GB of bf16 weights), grok-1 2 of 64 (~630 GB whole), chameleon-34b 16
# of 48 (~68 GB whole); whisper-tiny whole. phi serves phase 15's 8
# requests, grok its first 4, whisper all 8 (max_new 16, 4 slots, capacity
# 512); chameleon 4 seeded prompts of 1 100-1 400 tokens (past its 1 024
# image positions) at capacity 1 440, speculating at k 8 (a verify window of
# 9 x 8 = 72 rows per KV head)
PHI_ARCH, GROK_ARCH = "phi3.5-moe-42b-a6.6b", "grok-1-314b"
CH_ARCH, WH_ARCH = "chameleon-34b", "whisper-tiny"
FAM_DEPTH = {PHI_ARCH: 8, GROK_ARCH: 2, CH_ARCH: 16, WH_ARCH: None}
FAM_MAX_NEW, FAM_MAX_BATCH, GROK_REQUESTS = 16, 4, 4
CH_REQUESTS, CH_PROMPT_LENS, CH_CAPACITY, CH_SPEC_K = 4, (1100, 1401), 1440, 8

# phase 17: the LM trainer on full-width whisper-tiny (4 + 4 layers,
# d_model 384, vocab 51 865, 1 500 source frames; random f32 weights from
# seed 0) through its CLI, MDBO at phase 13's K, per-node batch and step
# counts: per_step for one eval interval, then fused (one capture, two
# replays)
WT_ARGV = ["--arch", WH_ARCH, "--steps", str(TR_STEPS), "--eval-every",
           str(TR_EVAL)]

# phase 18: the dry run (repro_torch.launch.dryrun) of the trainer's step on
# the one-card mesh at phases 13's and 17's workloads (MDBO on the ring mix,
# K = 4, 2 x 32 tokens a node, J = 2), traced on meta tensors in a worker
# process while phases 2-17 run, held against the same step on the card:
# its inputs' bytes and its flops exactly, its peak within DRY_PEAK_RTOL of
# the card's, and DRY_REPLAYS replays of a one-step graph no faster than
# the compute bound
DRY_ARCHS, DRY_PEAK_RTOL, DRY_REPLAYS = (TR_ARCH, WH_ARCH), 0.15, 5
# ... and to arithmetic of its own: one forward of loss_fn on a node's batch
# equal to forward_flops, and the step's flops within DRY_FACTOR_RTOL of
# K x that forward x (9 + 9 J): each of the two gradients (of f, and of g in
# y) costs 3 forwards (the forward, the input and the weight products), the
# cross JVP 3 (the forward and its tangent's 2), each of the J
# Hessian-vector products 9 (the forward 1, its tangent 2, the backward 2,
# the backward's tangent 4); found 26.08 and 26.76 for 27 on meta tensors
DRY_FACTOR_RTOL = 0.10
# (c): adamw after clip_by_global_norm on the card against the CPU: the
# same f32 arithmetic, a division and a square root an ulp apart at most,
# over OPT_STEPS steps, relative to each leaf's largest magnitude
OPT_STEPS, OPT_RTOL = 5, 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, *, n=50, warmup=5, flush=None):
    """Median time of one call of ``fn`` on the card, from CUDA events
    around each call. ``flush`` is overwritten before each call so the call
    finds the L2 cache cold, as a decode step's attention finds it after
    the layer's weights have streamed through. A ~1 ms spin kernel then
    keeps the card busy while the host enqueues the call, so the events
    time the card's work and not the host's launch gaps."""
    times = []
    for i in range(warmup + n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def paged_case(torch, gen, *, lengths, H, Hkv, Dh, L, bs, n_pages,
               num_blocks, dtype, alias_pages, Q=None):
    """Pool, q (``[B, H, Dh]``, or ``[B, Q, H, Dh]`` for a window of Q) and
    permuted tables on the card. Slot 1 aliases the first ``alias_pages``
    pages of slot 0 (a shared prompt prefix). A length past the table's
    ``n_pages`` gets a full table: its last rows run past the coverage."""
    dev = gen.device
    shape = (num_blocks + 1, bs, L, Hkv, Dh)
    kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q_shape = (len(lengths),) + ((Q,) if Q else ()) + (H, Dh)
    q = torch.randn(q_shape, generator=gen, device=dev).to(dtype)
    order = list(np.random.default_rng(SEED).permutation(num_blocks))
    tables = np.full((len(lengths), n_pages), num_blocks, np.int32)
    for i, n in enumerate(lengths):
        for j in range(min(-(-n // bs), n_pages)):
            tables[i, j] = (tables[0, j] if i == 1 and j < alias_pages
                            else order.pop())
    return (q, kp, vp, torch.as_tensor(tables, device=dev),
            torch.as_tensor(np.asarray(lengths, np.int32), device=dev))


def bound_ms(q, kp, tables, lengths):
    """Least time for one call: the bytes it must move (the K and V rows of
    one layer that the live positions reach through the tables, each
    physical row once however many slots alias its page; q, the tables,
    the lengths, the output) over the HBM rate, or its flops (QK and PV: 4
    per position each row attends, per query channel) over the dtype's
    peak, whichever is larger. ``q`` is ``[B, H, Dh]`` or a window
    ``[B, Q, H, Dh]``, whose row r attends ``min(length - (Q-1-r),
    coverage)`` positions."""
    B, H, Dh = q.shape[0], q.shape[-2], q.shape[-1]
    Q = q.shape[1] if q.dim() == 4 else 1
    bs, Hkv = kp.shape[1], kp.shape[3]
    n_pages = tables.shape[1]
    cover = n_pages * bs
    lens = lengths.cpu().numpy().astype(np.int64)
    tab = tables.cpu().numpy().astype(np.int64)
    rows = [tab[b, pos // bs] * bs + pos % bs
            for b, pos in enumerate(np.arange(min(n, cover)) for n in lens)]
    live = int(np.unique(np.concatenate(rows)).size)
    row_lens = lens[:, None] - (Q - 1 - np.arange(Q))[None]
    attended = int(np.clip(row_lens, 0, cover).sum())
    esz = q.element_size()
    nbytes = (2 * live * Hkv * Dh * esz + 2 * B * Q * H * Dh * esz
              + B * n_pages * 4 + B * 4)
    flops = 4 * attended * H * Dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(torch, cfg):
    """Phase 3: the paged-attention kernel vs its plain version."""
    from repro_torch.kernels import paged_attention, paged_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_pages = CAPACITY // BLOCK_SIZE
    # the serving path's shapes: max_batch slots, smollm's heads, bf16, the
    # serving pool; every tail class, a dead slot, a full-capacity slot,
    # and slot 1 sharing slot 0's first 7 pages
    lengths = [120, 200, 0, 1, 16, 17, 299, CAPACITY - 4]
    case = paged_case(torch, gen, lengths=lengths, H=cfg.n_heads,
                      Hkv=cfg.n_kv_heads, Dh=cfg.head_dim, L=cfg.n_layers,
                      bs=BLOCK_SIZE, n_pages=n_pages,
                      num_blocks=NUM_BLOCKS, dtype=cfg.dtype,
                      alias_pages=7)
    out = paged_attention(*case, cfg.n_layers - 1)
    ref = paged_attention_ref(*case, cfg.n_layers - 1)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - (BF16_ATOL + BF16_RTOL * ref.float().abs())).max())
    if not torch.isfinite(out).all() or float(out[2].abs().max()) != 0.0:
        raise AssertionError("paged_attention: non-finite output or a dead "
                             "slot that is not zero")
    if excess > 0:
        raise AssertionError(f"paged_attention bf16: |kernel - plain| "
                             f"exceeds {BF16_ATOL} + {BF16_RTOL} |plain| "
                             f"by {excess} (max |kernel - plain| {err})")

    small = paged_case(torch, gen, lengths=[5, 9, 0, 24], H=6, Hkv=2, Dh=32,
                       L=2, bs=8, n_pages=4, num_blocks=12,
                       dtype=torch.float32, alias_pages=1)
    err32 = float((paged_attention(*small, 1).float()
                   - paged_attention_ref(*small, 1).float()).abs().max())
    if err32 > TOL_F32:
        raise AssertionError(f"paged_attention f32: max |kernel - plain| "
                             f"{err32} > {TOL_F32}")

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    layer = cfg.n_layers - 1
    ms = cuda_ms(torch, lambda: paged_attention(*case, layer), flush=flush)
    plain_ms = cuda_ms(torch, lambda: paged_attention_ref(*case, layer),
                       flush=flush)
    bound, bound_by = bound_ms(case[0], case[1], case[3], case[4])
    del flush
    print(f"[3] paged_attention bf16 B={len(lengths)} H={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads} Dh={cfg.head_dim} bs={BLOCK_SIZE} "
          f"L={cfg.n_layers} n_pages={n_pages}: max_abs_err {err:.3e} "
          f"(tol {BF16_ATOL} + {BF16_RTOL} |plain|, |plain| max "
          f"{float(ref.float().abs().max()):.3f}); f32 small shape "
          f"{err32:.3e} (tol {TOL_F32})")
    print(f"[3] paged_attention {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by}), L2 cold")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:213",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def workload(vocab, n=N_REQUESTS):
    """``n`` seeded prompts of 17–300 tokens; requests 1 and 3 share a
    128-token prefix."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=n)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
               for n in lens]
    prefix = rng.integers(0, vocab, size=SHARED_PREFIX).astype(np.int32)
    for i, tail in ((1, 40), (3, 70)):
        prompts[i] = np.concatenate([prefix, prompts[i][:tail]])
    return prompts


def ptxas_report(logs) -> list[str]:
    """One line per compiled kernel instantiation from ``nvcc -Xptxas -v``:
    the kernel, its dtype and head dim (from the mangled name), then
    ptxas's spill and register lines."""
    out, label = [], None
    for log in logs.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                sym = next((k for k in KERNEL_SYMBOLS.values() if k in line),
                           line)
                dtype = "bf16" if "__nv_bfloat16" in line else "f32"
                dh = re.search(r"Li(\d+)E", line)
                tiled = ", tiled" if "paged" in sym and "Lb1E" in line \
                    else ""
                label = (f"{sym}<{dtype}{', ' + dh.group(1) if dh else ''}"
                         f"{tiled}>")
                out.append(label + ":")
            elif label and ("registers" in line or "spill" in line):
                out[-1] += " " + line.split(":", 1)[-1].strip() + ";"
    return out


def sass_counts(sass: str) -> dict:
    """``{label: (HMMA, FFMA)}`` for each ``flash_attention_kernel``
    instantiation in ``cuobjdump -sass`` output: its tensor-core and f32
    FMA instructions."""
    counts, label = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            label = None
            if KERNEL_SYMBOLS["flash_attention"] in fn.group(1):
                dh = re.search(r"Li(\d+)E", fn.group(1))
                dtype = "bf16" if "bfloat16" in fn.group(1) else "f32"
                label = f"flash_attention_kernel<{dtype}, {dh.group(1)}>"
                counts[label] = [0, 0]
        elif label:
            counts[label][0] += bool(re.search(r"\bHMMA\b", line))
            counts[label][1] += bool(re.search(r"\bFFMA\b", line))
    return {label: tuple(n) for label, n in counts.items()}


def check_sass(counts: dict) -> list[str]:
    """Every bf16 flash instantiation (head dims 32, 64, 128, 256) runs its
    products on the tensor cores: its SASS holds ``HMMA``. One line per
    instantiation."""
    for dh in (32, 64, 128, 256):
        label = f"flash_attention_kernel<bf16, {dh}>"
        if counts.get(label, (0, 0))[0] == 0:
            raise AssertionError(f"{label}: no HMMA in its SASS "
                                 f"({counts.get(label, 'not found')})")
    return [f"{label}: {n_hmma} HMMA, {n_ffma} FFMA in its SASS"
            for label, (n_hmma, n_ffma) in sorted(counts.items())]


def sass_report(build) -> list[str]:
    """Read the built flash library's SASS with ``cuobjdump`` (beside
    ``nvcc``; a missing tool fails the run) and check it (``check_sass``)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool, "-sass", str(build.library_path("flash_attention"))],
        check=True, capture_output=True, text=True).stdout
    return check_sass(sass_counts(sass))


def reset_counts():
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch import kernels as K

    for name in KERNEL_SYMBOLS:
        getattr(K, name).launches = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from repro_torch import kernels as K

    return {name: getattr(K, name).launches for name in KERNEL_SYMBOLS}


def drain(torch, eng, prompts, max_new):
    """Submit ``prompts`` and run the engine to the end, with every kernel's
    launch count set to 0 just before and read just after. Returns (streams,
    metrics)."""
    reset_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    streams = [results[r] for r in rids]
    ttft = [eng.completed[r].first_token_s - eng.completed[r].submit_s
            for r in rids]
    tokens = sum(map(len, streams))
    return streams, {"wall_s": wall, "tokens": tokens,
                     "tokens_per_s": tokens / wall,
                     "ttft_p50_ms": float(np.median(ttft)) * 1e3,
                     "ttft_max_ms": float(np.max(ttft)) * 1e3,
                     "counts": counts, "launches": counts["paged_attention"],
                     "multi_launches": counts["paged_attention_multi"],
                     "flash_launches": counts["flash_attention"],
                     **eng.stats}


def serve(torch, cfg, params, device, speculate=None):
    """Phase 4 (and 7b with ``speculate``): drive the paged engine; returns
    (engine, prompts, streams, metrics)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, mode="paged", capacity=CAPACITY,
                      max_batch=MAX_BATCH, block_size=BLOCK_SIZE,
                      num_blocks=NUM_BLOCKS, decode_chunk=DECODE_CHUNK,
                      speculate=speculate, device=device)
    prompts = workload(cfg.vocab)
    streams, metrics = drain(torch, eng, prompts, MAX_NEW)
    return eng, prompts, streams, metrics


def check_counts(what, counts, want):
    """Fail unless every kernel wrapper counted exactly ``want`` (0 where
    unnamed) and each named kernel launched at least once."""
    want = {name: want.get(name, 0) for name in KERNEL_SYMBOLS}
    if counts != want or not all(want[n] > 0 for n in want if want[n]):
        raise AssertionError(f"{what}: kernel launches {counts}, want {want}")


def paged_want(cfg, st, rounds=0):
    """Launches a paged drain must count: the decode kernel per layer per
    decode step (or the window kernel per layer per verify round), and the
    flash kernel per layer per target prefill and per draft layer per
    draft prefill."""
    flash = cfg.n_layers * st["prefills"] \
        + SPEC_DRAFT_LAYERS * st.get("draft_prefills", 0)
    if rounds:
        return {"paged_attention_multi": cfg.n_layers * rounds,
                "flash_attention": flash}
    return {"paged_attention": cfg.n_layers * st["decode_steps"],
            "flash_attention": flash}


def check_serve(cfg, streams, metrics):
    if any(len(s) != MAX_NEW for s in streams):
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        raise AssertionError("token out of the vocabulary")
    if metrics["preemptions"] < 1:
        raise AssertionError("the pool did not force a preemption")
    if metrics["peak_shared_blocks"] < 1:
        raise AssertionError("no prompt prefix was shared")
    check_counts("paged drain", metrics["counts"], paged_want(cfg, metrics))


def replay(torch, cfg, params, prompts, streams, attend, device, *,
           capacity=CAPACITY, max_new=MAX_NEW, prefill_attend=None,
           extras=None, widths=None):
    """Teacher-forced per-step logits [n, max_new, V] (f32): prefill
    (through ``prefill_attend``, the flash kernel when None; with the
    family's ``extras(tokens)``, the engine's ``_prefill_inputs``, when
    given), then each served token fed back through ``paged_decode_step``
    with ``attend``. ``widths``: the table width the engine handed each
    decode chunk (its high-water clamp), which sets the kernel's split of
    the positions; the whole table when None."""
    from repro_torch.kernels import ops
    from repro_torch.models import prefill
    from repro_torch.models.paged import paged_decode_step
    from repro_torch.serve.batch import tail_targets, write_prefill

    n, pages = len(prompts), capacity // BLOCK_SIZE
    shape = (n * pages + 1, BLOCK_SIZE, cfg.n_layers, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"kv": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for k in ("k", "v")}}
    tables = torch.arange(n * pages, dtype=torch.int32,
                          device=device).reshape(n, pages)
    steps = []
    first = []
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(p[None], device=device)
        kw = extras(toks) if extras else {"tokens": toks}
        at_site([("pre", i)])
        lg, cache = prefill(cfg, params, kw.pop("tokens"), capacity,
                            attend=prefill_attend or ops.attention, **kw)
        write_prefill(pool, cache, tables[i], block_size=BLOCK_SIZE)
        first.append(lg[0, -1].float())
    steps.append(torch.stack(first))
    idx = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    for t in range(max_new - 1):
        tok = torch.as_tensor([s[t] for s in streams], dtype=torch.int32,
                              device=device)
        tab = tables if widths is None else \
            tables[:, :widths[t // DECODE_CHUNK]].contiguous()
        blk, off = tail_targets(tab, idx, live, BLOCK_SIZE, n * pages)
        at_site([("dec", i, t) for i in range(n)])
        lg, _ = paged_decode_step(cfg, params, tok, pool["kv"], tab, blk,
                                  off, idx, idx + 1, attend=attend)
        steps.append(lg.float())
        idx = idx + 1
    return torch.stack(steps, dim=1)


def check_replay(torch, cfg, params, prompts, streams, device):
    """Phase 5: kernel vs plain attention on the served streams."""
    from repro_torch.kernels import paged_attention, paged_attention_ref

    ker = replay(torch, cfg, params, prompts, streams, paged_attention,
                 device)
    plain = replay(torch, cfg, params, prompts, streams, paged_attention_ref,
                   device)
    diff = float((ker - plain).abs().max())
    served = torch.as_tensor(streams, device=device).long()
    served_logit = plain.gather(-1, served[..., None])[..., 0]
    gap = float((plain.max(-1).values - served_logit).max())
    agree = float((plain.argmax(-1) == served).float().mean())
    print(f"[5] replay over {len(prompts)} x {MAX_NEW} steps: max |logits "
          f"kernel - plain| {diff:.4f} (tol {TOL_REPLAY}); served token "
          f"within {gap:.4f} of the plain argmax logit (tol {TOL_REPLAY}); "
          f"argmax agreement {agree:.4f}; |logit| max "
          f"{float(plain.abs().max()):.3f}")
    if not torch.isfinite(ker).all() or diff > TOL_REPLAY \
            or gap > TOL_REPLAY:
        raise AssertionError("replay: the served streams disagree with the "
                             "plain attention beyond the bf16 tolerance")
    return diff, gap, agree


def check_trace(rows, counted, want, tag):
    """The traced-launch check of a profiled drain. ``rows`` are the
    trace's device events other than the window's spins, as (name, ms,
    count); ``counted`` the wrappers' counts; ``want`` the launches the
    drain's path must make of each kernel. Every wrapper must have counted
    exactly ``want``, and the trace must show each kernel under its own name
    exactly as often (a lost record, a kernel of another path, or a plain
    version run in a kernel's place shows as a count that is off). Returns
    the traced counts."""
    n_traced = {name: sum(c for key, _, c in rows if sym in key)
                for name, sym in KERNEL_SYMBOLS.items()}
    check_counts(f"{tag} profiled drain, counted", counted, want)
    check_counts(f"{tag} profiled drain, traced", n_traced, want)
    return n_traced


def warm_up_profiler(torch):
    """Start and stop the profiler once on a trivial kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()


def spin_burst(torch):
    """``TRACE_BURST`` spin kernels, run to their end."""
    for _ in range(TRACE_BURST):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_records(torch, prof):
    """The trace's device-side records (kernels, copies), not the runtime
    calls on the host that launched them, as (name, duration in ns). Read
    from the profiler's raw result, ``prof.profiler.kineto_results``, which
    is not public torch API: building the per-event Python objects of
    ``prof.events()`` took seconds a drain. Where a torch release lacks
    it, the events are read through ``prof.events()`` instead."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None and hasattr(raw, "events"):
        return [(e.name(), e.duration_ns()) for e in raw.events()
                if e.device_type() == cuda]
    return [(e.name, int(e.time_range.elapsed_us() * 1e3))
            for e in prof.events() if e.device_type == cuda]


def profile_drain(torch, eng, vocab, want_fn, tag="[6]"):
    """Phase 6 (and 7b, 10, 11, 16): where the time goes. One more drain (8
    requests of 64 prompt tokens, one decode chunk each) under
    ``torch.profiler``: wall time, the card's busy time, and the kernels
    that took it. ``want_fn(stats)`` gives the launches this drain's path
    must make of each kernel (its stats in hand); :func:`check_trace` holds
    the wrappers' counts and the trace to it."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, vocab, size=64).astype(np.int32),
                   max_new_tokens=DECODE_CHUNK + 1)
    torch.cuda.synchronize()
    reset_counts()
    t_trace = time.perf_counter()
    # the card's activity only: the busy share and the kernel counts need
    # nothing else, and the host's operator events would double the trace
    # and its parsing time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spin_burst(torch)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_TAIL_S)
    counted = read_counts()
    t_parse = time.perf_counter()
    spins, by_name = 0, {}
    for name, dur_ns in device_records(torch, prof):
        if TRACE_SPIN in name:
            spins += 1
            continue
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur_ns / 1e6, count + 1)
    rows = [(key, ms, count) for key, (ms, count) in by_name.items()]
    t_done = time.perf_counter()
    print(f"{tag} trace window: the profiler dropped {TRACE_BURST - spins} "
          f"of the {TRACE_BURST} spins that open it")
    n_traced = check_trace(rows, counted, want_fn(eng.stats), tag)
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no time on the card")
    rows.sort(key=lambda r: -r[1])
    print(f"{tag} profiled drain: wall {wall_ms:.1f} ms, card busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), decode steps "
          f"{eng.stats['decode_steps']}, prefills {eng.stats['prefills']}; "
          f"traced {t_parse - t_trace:.1f} s, parsed {t_done - t_parse:.1f} s")
    for key, ms, count in rows[:8]:
        print(f"{tag}   {ms:9.3f} ms  {count:6d} x  {key[:90]}")
    for name, sym in KERNEL_SYMBOLS.items():
        if n_traced[name]:
            k_ms = sum(ms for key, ms, _ in rows if sym in key)
            print(f"{tag}   {name} ({sym}): {k_ms:.3f} ms in "
                  f"{n_traced[name]} launches ({k_ms / busy_ms:.1%} of the "
                  f"card's busy time)")
    return busy_ms, wall_ms


def check_multi_kernel(torch, cfg):
    """Phase 7a: the verify-window kernel vs its plain version."""
    from repro_torch.kernels import (paged_attention, paged_attention_multi,
                                     paged_attention_multi_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    Q, n_pages, layer = SPEC_K + 1, CAPACITY // BLOCK_SIZE, cfg.n_layers - 1
    # lengths after the window's appends: windows crossing a page (18, 33),
    # a dead slot, a window as long as its slot (4: row 0 sees one
    # position), a full-capacity slot whose last rows run past the table
    # (CAPACITY + 2), and slot 1 sharing slot 0's first 7 pages
    lengths = [120, 200, 0, 18, 33, 4, 299, CAPACITY + 2]
    case = paged_case(torch, gen, lengths=lengths, H=cfg.n_heads,
                      Hkv=cfg.n_kv_heads, Dh=cfg.head_dim, L=cfg.n_layers,
                      bs=BLOCK_SIZE, n_pages=n_pages, num_blocks=NUM_BLOCKS,
                      dtype=cfg.dtype, alias_pages=7, Q=Q)
    out = paged_attention_multi(*case, layer)
    ref = paged_attention_multi_ref(*case, layer)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - (BF16_ATOL + BF16_RTOL * ref.float().abs())).max())
    if not torch.isfinite(out).all() or float(out[2].abs().max()) != 0.0:
        raise AssertionError("paged_attention_multi: non-finite output or a "
                             "dead slot that is not zero")
    if excess > 0:
        raise AssertionError(f"paged_attention_multi bf16: |kernel - plain| "
                             f"exceeds {BF16_ATOL} + {BF16_RTOL} |plain| by "
                             f"{excess} (max |kernel - plain| {err})")

    small = paged_case(torch, gen, lengths=[5, 9, 0, 26, 2], H=6, Hkv=2,
                       Dh=32, L=2, bs=8, n_pages=3, num_blocks=14,
                       dtype=torch.float32, alias_pages=1, Q=Q)
    err32 = float((paged_attention_multi(*small, 1)
                   - paged_attention_multi_ref(*small, 1)).abs().max())
    if err32 > TOL_F32:
        raise AssertionError(f"paged_attention_multi f32: max |kernel - "
                             f"plain| {err32} > {TOL_F32}")
    # a window of one is decode: the same template, the same bits
    q1 = case[0][:, :1].contiguous()
    one = paged_attention_multi(q1, *case[1:], layer)
    if not torch.equal(one[:, 0], paged_attention(q1[:, 0], *case[1:],
                                                   layer)):
        raise AssertionError("paged_attention_multi at Q = 1 differs from "
                             "paged_attention")

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    ms = cuda_ms(torch, lambda: paged_attention_multi(*case, layer),
                 flush=flush)
    plain_ms = cuda_ms(torch,
                       lambda: paged_attention_multi_ref(*case, layer),
                       flush=flush)
    bound, bound_by = bound_ms(case[0], case[1], case[3], case[4])
    del flush
    print(f"[7a] paged_attention_multi bf16 B={len(lengths)} Q={Q} "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} Dh={cfg.head_dim} "
          f"bs={BLOCK_SIZE} L={cfg.n_layers} n_pages={n_pages}: max_abs_err "
          f"{err:.3e} (tol {BF16_ATOL} + {BF16_RTOL} |plain|, |plain| max "
          f"{float(ref.float().abs().max()):.3f}); f32 small shape "
          f"{err32:.3e} (tol {TOL_F32}); Q=1 equals paged_attention")
    print(f"[7a] paged_attention_multi {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({bound_by}), L2 cold")
    return {"name": "paged_attention_multi", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:145",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def damped(torch, params, first, factor):
    """A copy of ``params`` with every layer from ``first`` on scaled by
    ``factor``."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        out = tree.clone()
        out[first:] *= factor
        return out

    return {**params, "layers": walk(params["layers"])}


def spec_drain(torch, cfg, params, device):
    """Phase 7b: the speculative drain and a non-speculative drain of the
    same damped target. Returns (spec engine, prompts, spec streams,
    plain streams, spec metrics, plain metrics)."""
    from repro_torch.serve import SpecConfig
    from repro_torch.weights import truncate_params

    target = damped(torch, params, SPEC_DRAFT_LAYERS, SPEC_DAMP)
    spec = SpecConfig(cfg.with_overrides(n_layers=SPEC_DRAFT_LAYERS),
                      truncate_params(target, SPEC_DRAFT_LAYERS), k=SPEC_K)
    eng, prompts, streams, m = serve(torch, cfg, target, device,
                                     speculate=spec)
    m["rounds"] = m["decode_dispatches"] * spec.rounds_for(DECODE_CHUNK)
    m["acceptance"] = m["spec_accepted"] / max(m["spec_proposed"], 1)
    _, _, base, bm = serve(torch, cfg, target, device)
    return eng, prompts, streams, base, m, bm


def check_spec(cfg, streams, m):
    if any(len(s) != MAX_NEW for s in streams):
        raise AssertionError(f"spec stream lengths "
                             f"{[len(s) for s in streams]}")
    # the decode kernel must not launch: the draft attends with sdpa
    check_counts("speculative drain", m["counts"],
                 paged_want(cfg, m, rounds=m["rounds"]))
    partial = m["spec_rounds"] - m["spec_full_rounds"]
    if not (m["spec_accepted"] > 0 and m["spec_full_rounds"] > 0
            and partial > 0):
        raise AssertionError(f"need accepted drafts, rounds that accept all "
                             f"k and rounds that reject some: accepted "
                             f"{m['spec_accepted']}, full rounds "
                             f"{m['spec_full_rounds']}, partial {partial}")


def replay_windows(torch, cfg, params, prompts, streams, attend, device, *,
                   capacity=CAPACITY, max_new=MAX_NEW, k=None, extras=None):
    """Teacher-forced per-step logits [n, max_new, V] (f32) through the
    verify step: prefill (with the family's ``extras`` as in
    :func:`replay`), then the served tokens fed back in windows of k + 1
    (``SPEC_K`` unless given) through ``paged_verify_step``."""
    from repro_torch.models import prefill
    from repro_torch.models.paged import paged_verify_step
    from repro_torch.serve.batch import tail_targets_multi, write_prefill

    n, pages = len(prompts), capacity // BLOCK_SIZE
    shape = (n * pages + 1, BLOCK_SIZE, cfg.n_layers, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"kv": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for k in ("k", "v")}}
    tables = torch.arange(n * pages, dtype=torch.int32,
                          device=device).reshape(n, pages)
    first = []
    for i, p in enumerate(prompts):
        toks = torch.as_tensor(p[None], device=device)
        kw = extras(toks) if extras else {"tokens": toks}
        at_site([("pre", i)])
        lg, cache = prefill(cfg, params, kw.pop("tokens"), capacity, **kw)
        write_prefill(pool, cache, tables[i], block_size=BLOCK_SIZE)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)[:, None]]
    idx = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    served = torch.as_tensor(streams, dtype=torch.int32, device=device)
    k = k or SPEC_K
    for t0 in range(0, max_new - 1, k + 1):
        Q = min(k + 1, max_new - 1 - t0)
        blks, offs = tail_targets_multi(tables, idx, live, Q, BLOCK_SIZE,
                                        n * pages)
        pos = idx[:, None] + torch.arange(Q, dtype=torch.int32,
                                          device=device)
        at_site([("dec", i, t0 + r) for i in range(n) for r in range(Q)])
        lg, _ = paged_verify_step(cfg, params,
                                  served[:, t0:t0 + Q].contiguous(),
                                  pool["kv"], tables, blks, offs, pos,
                                  idx + Q, attend=attend)
        steps.append(lg.float())
        idx = idx + Q
    return torch.cat(steps, dim=1)


def replay_pair(torch, cfg, run_kernel, run_plain, tag):
    """``(run_kernel(), run_plain())``: a teacher-forced replay through the
    kernels and one through their plain versions. An MoE layer's routing is
    a discrete choice (the top-k experts, and the capacity's drops in a
    joint prefill) that an ulp of attention output can flip, after which
    the two replays compute with other experts. So for the moe family the
    plain replay takes the kernel replay's routing (its own router weights
    at the kernel replay's experts; :func:`pinned_routing`), which holds the
    attention to its error model; the routings it would have chosen
    otherwise are counted, and each must be a near-tie: its own experts
    hold at most ``MOE_TIE`` more router weight, relative, than the
    pinned ones."""
    if cfg.family != "moe":
        return run_kernel(), run_plain()
    with pinned_routing(torch) as pin:
        ker = run_kernel()
        pin["replay"] = True
        plain = run_plain()
        print(f"{tag} the plain replay took the kernel replay's MoE routing "
              f"at {pin['calls']} routing groups; unpinned, {pin['flipped']} "
              f"of them would have chosen other experts or drops, their "
              f"experts at most {pin['tie']:.2e} apart in router weight "
              f"(limit {MOE_TIE})")
    return ker, plain


# Where the replays' MoE routings happen (pinned_routing keys them by it):
# ``keys`` names each routing group of the next model call, ``layer``
# counts that call's layers, and ``offset`` is added to a replay's request
# indices (in_batches sets it to the batch's first request).
SITE = {"keys": None, "layer": 0, "offset": 0}


def at_site(keys):
    """Name the routing groups of the next model call: ``("pre", i)`` for
    request i's prefill (one group), ``("dec", i, t)`` for the token that
    feeds request i's served token t (one group each)."""
    off = SITE["offset"]
    SITE["keys"] = [(k[0], k[1] + off, *k[2:]) for k in keys]
    SITE["layer"] = 0


@contextlib.contextmanager
def pinned_routing(torch):
    """Record every MoE routing group, keyed by its site (:data:`SITE`) and
    layer, while ``pin["replay"]`` is false; once it is set, each routing
    group returns the choice recorded at its key (experts, positions,
    drops) with its own router weights at those experts, renormalised, and
    counts where its own choice differed. Keys, not call order, match the
    groups, so the two replays may batch the requests differently."""
    from repro_torch.models import moe

    route, recorded = moe.route, {}
    pin = {"replay": False, "calls": 0, "flipped": 0, "tie": 0.0}
    fields = ("top_e", "pos", "keep", "dest")

    def pinned(cfg, p, flat):
        r = route(cfg, p, flat)
        keys = [(*k, SITE["layer"]) for k in SITE["keys"]]
        SITE["layer"] += 1
        if len(keys) != flat.shape[0]:
            raise AssertionError(f"{len(keys)} routing sites named for "
                                 f"{flat.shape[0]} groups")
        if not pin["replay"]:
            for g, key in enumerate(keys):
                recorded[key] = {f: r[f][g] for f in fields}
            return r
        rec = {f: torch.stack([recorded[k][f] for k in keys])
               for f in fields}
        pin["calls"] += len(keys)
        w = torch.gather(r["probs"], -1, rec["top_e"])
        if not (torch.equal(r["top_e"], rec["top_e"])
                and torch.equal(r["keep"], rec["keep"])):
            pin["flipped"] += int(((r["top_e"] != rec["top_e"]).flatten(1)
                                   .any(1) | (r["keep"] != rec["keep"])
                                   .any(1)).sum())
            # how much router weight its own experts hold over the pinned
            # ones, relative, at the tokens whose experts differ
            own = torch.gather(r["probs"], -1, r["top_e"]).sum(-1)
            gap = (own - w.sum(-1)) / own
            pin["tie"] = max(pin["tie"], float(gap.max()))
        return {**r, "top_e": rec["top_e"], "pos": rec["pos"],
                "keep": rec["keep"], "dest": rec["dest"],
                "top_w": w / torch.sum(w, dim=-1, keepdim=True)}

    moe.route = pinned
    try:
        yield pin
    finally:
        moe.route = route
    if pin["calls"] != len(recorded):
        raise AssertionError(f"pinned routing: {pin['calls']} routing "
                             f"groups replayed, {len(recorded)} recorded")
    if pin["tie"] > MOE_TIE:
        raise AssertionError(f"pinned routing: a routing flipped where its "
                             f"experts were {pin['tie']:.4f} apart (limit "
                             f"{MOE_TIE}): not a near-tie")


def check_spec_replay(torch, cfg, params, prompts, streams, base, device,
                      tag="[7b]", **shape):
    """Phase 7b (and 15, 16): spec streams that differ from the
    non-speculative ones (near-ties in bf16) must be what the plain
    attention would serve. ``shape``: the drain's ``capacity`` and
    ``max_new`` (and ``k`` and the family's ``extras`` for
    :func:`replay_windows`)."""
    from repro_torch.kernels import paged_attention_multi, \
        paged_attention_multi_ref

    differ = [i for i in range(len(streams)) if streams[i] != base[i]]
    if cfg.family == "moe":
        # the verify windows of the drain start where each round's
        # acceptance left them, the replay's every k + 1 tokens: their
        # attention rounds otherwise, and an MoE routing near-tie can then
        # take other experts, so the served tokens are not held to the
        # replay. The window kernel is held to its plain version on every
        # stream, with the routing pinned, and each stream's first token
        # (the same prefill on both drains) must be its base's.
        differ = list(range(len(streams)))
        if any(s[0] != b[0] for s, b in zip(streams, base)):
            raise AssertionError(f"{tag}: a first token differs from the "
                                 "non-speculative drain's")
    if not differ:
        print(f"{tag} every speculative stream equals its non-speculative "
              "stream")
        return
    sel_p = [prompts[i] for i in differ]
    sel_s = [streams[i] for i in differ]
    ker, plain = replay_pair(
        torch, cfg, lambda: replay_windows(
            torch, cfg, params, sel_p, sel_s, paged_attention_multi, device,
            **shape),
        lambda: replay_windows(torch, cfg, params, sel_p, sel_s,
                               paged_attention_multi_ref, device, **shape),
        tag)
    diff = float((ker - plain).abs().max())
    served = torch.as_tensor(sel_s, device=device).long()
    served_logit = plain.gather(-1, served[..., None])[..., 0]
    gap = float((plain.max(-1).values - served_logit).max())
    n_differ = sum(s != b for s, b in zip(streams, base))
    print(f"{tag} {n_differ} of {len(streams)} speculative streams differ "
          f"from the non-speculative ones; window replay of {len(differ)}: "
          f"max |logits kernel - plain| {diff:.4f} (tol {TOL_REPLAY}); "
          f"served token within {gap:.4f} of the plain argmax logit (tol "
          f"{TOL_REPLAY}" + (", not held for the moe family)"
                             if cfg.family == "moe" else ")"))
    if cfg.family == "moe":
        gap = 0.0
    if not torch.isfinite(ker).all() or diff > TOL_REPLAY \
            or gap > TOL_REPLAY:
        raise AssertionError("spec replay: the served streams disagree with "
                             "the plain attention beyond the bf16 tolerance")


# ---------------------------------------------------------------------------
# Phases 8-10: the prefill kernels and continuous serving of recurrentgemma
# ---------------------------------------------------------------------------

def flash_case(torch, gen, *, B, H, Hkv, S, Dh, dtype, Skv=None):
    """q ``[B, H, S, Dh]`` and k/v ``[B, Hkv, Skv, Dh]`` (Skv = S unless
    given: cross-attention) on the card, each a ``[B, S, heads, Dh]``
    tensor viewed in the kernel's layout, as the model hands them over."""
    def one(heads, n):
        return torch.randn((B, n, heads, Dh), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)
    return one(H, S), one(Hkv, Skv or S), one(Hkv, Skv or S)


def attention_pairs(Sq, Skv, causal, window) -> int:
    """Unmasked (query, key) pairs of one head: the work the kernel must
    do, whatever tiles it touches."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_bound_ms(q, k, causal, window):
    """Least time for one call: q, k, v and the output moved once over the
    HBM rate, or 4 Dh flops per unmasked pair and query head (QK and PV)
    over the dtype's peak, whichever is larger."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    esz = q.element_size()
    nbytes = esz * (2 * B * H * Sq * Dh + 2 * B * Hkv * Skv * Dh)
    flops = 4 * Dh * B * H * attention_pairs(Sq, Skv, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_attention_ms(torch, q, k, v, causal, window, flush):
    """The library yardstick for the flash kernel: one
    ``scaled_dot_product_attention`` call on the same inputs (GQA by
    ``enable_gqa``; a sliding window as a boolean mask), checked to compute
    the same function and timed like the kernel. The port never calls it:
    it is the kernels line's ``library_ms`` and nothing else."""
    Sq, Skv = q.shape[2], k.shape[2]
    mask = None
    if window is not None or (causal and Sq != Skv):
        qp = torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        mask = kp > qp - (window or Skv + Sq)
        if causal:
            mask &= kp <= qp
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(q, k, v, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)

    return call(), cuda_ms(torch, call, flush=flush)


def within_limit(out, ref) -> float:
    """How far ``out`` exceeds its limit around ``ref`` (at most 0 when
    within): ``TOL_F32`` in f32, ``BF16_ATOL + BF16_RTOL |ref|`` in bf16."""
    diff = (out.float() - ref.float()).abs()
    if str(out.dtype) == str(ref.dtype) == "torch.float32":
        return float(diff.max()) - TOL_F32
    return float((diff - (BF16_ATOL + BF16_RTOL * ref.float().abs())).max())


def library_excess(out, ref, spread) -> float:
    """How far the library's output exceeds its limit around the plain
    version ``ref`` (at most 0 when within): ``TOL_F32`` in f32; in bf16
    the kernel's limit plus ``LIB_P_RTOL`` times ``spread``, the plain
    attention of |v|."""
    if str(out.dtype) == "torch.float32":
        return within_limit(out, ref)
    return float(((out.float() - ref.float()).abs() - BF16_ATOL
                  - BF16_RTOL * ref.float().abs()
                  - LIB_P_RTOL * spread.float()).max())


PHASE8_FLASH_CASES = [
    # (label, B, H, Hkv, S, Dh, dtype, causal, window[, Skv]); dtype by
    # name; Skv, the keys' length, is S unless given
    ("a recurrentgemma-2b", 1, 10, 1, 2300, 256, "bfloat16", True, 2048),
    ("b smollm-360m", 1, 15, 5, 300, 64, "bfloat16", True, None),
    ("S 100 (tail tile)", 1, 10, 1, 100, 256, "bfloat16", True, 64),
    ("S 37 < one tile", 1, 15, 5, 37, 64, "bfloat16", True, None),
    ("window 1", 1, 10, 1, 300, 256, "bfloat16", True, 1),
    ("non-causal", 2, 4, 2, 200, 128, "bfloat16", False, None),
    ("f32, window 64", 1, 10, 1, 300, 256, "float32", True, 64),
    ("f32 smollm heads", 1, 15, 5, 300, 64, "float32", True, None),
]


def check_flash_kernel(torch, cases=PHASE8_FLASH_CASES, tag="[8]",
                       seed=SEED + 8):
    """Phase 8 (and 15): the flash-attention kernel vs its plain version
    at each case, each timed beside the plain version and the library
    yardstick, L2 cold. Phase 8's cases are both prefill shapes of the
    serving paths — (a) recurrentgemma-2b's (10 query heads over one KV
    head, Dh 256, the 2 048 window, a 2 300-token prompt) and (b)
    smollm-360m's (15 over 5, Dh 64, causal, 300 tokens) — and edge
    cases. Returns the kernels-line entry of each case, in order."""
    from repro_torch.kernels import attention_ref, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = torch.float32
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    rows = []
    for label, B, H, Hkv, S, Dh, dtype, causal, window, *skv in cases:
        Skv = skv[0] if skv else S
        dtype = getattr(torch, dtype)
        q, k, v = flash_case(torch, gen, B=B, H=H, Hkv=Hkv, S=S, Dh=Dh,
                             dtype=dtype, Skv=Skv)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        excess = within_limit(out, ref)
        tol = (f"{TOL_F32}" if dtype == f32
               else f"{BF16_ATOL} + {BF16_RTOL} |plain|")
        print(f"{tag} flash_attention {label}: B={B} H={H} Hkv={Hkv} S={S} "
              f"Skv={Skv} Dh={Dh} {str(dtype)[6:]} causal={causal} "
              f"window={window}: "
              f"max_abs_err {err:.3e} (tol {tol}, |plain| max "
              f"{float(ref.float().abs().max()):.3f})")
        if not torch.isfinite(out).all() or excess > 0:
            raise AssertionError(f"flash_attention {label}: |kernel - plain| "
                                 f"exceeds its limit by {excess}")
        ms = cuda_ms(torch, lambda: flash_attention(
            q, k, v, causal=causal, window=window), flush=flush)
        plain_ms = cuda_ms(torch, lambda: attention_ref(
            q, k, v, causal=causal, window=window), flush=flush)
        lib_out, library_ms = library_attention_ms(torch, q, k, v, causal,
                                                   window, flush)
        lib_err = float((lib_out.float() - ref.float()).abs().max())
        spread = attention_ref(q, k, v.abs(), causal=causal, window=window)
        lib_excess = library_excess(lib_out, ref, spread)
        if not lib_excess <= 0:
            raise AssertionError(f"the library yardstick computes another "
                                 f"function ({label}: |library - plain| "
                                 f"exceeds its limit by {lib_excess}; max "
                                 f"{lib_err})")
        if window is not None and window < S and dtype != f32:
            # the limit tells the windowed function from the causal one
            unmasked, _ = library_attention_ms(torch, q, k, v, causal, None,
                                               flush)
            no_window = library_excess(unmasked, ref, spread)
            print(f"{tag} flash_attention {label}: the library without its "
                  f"window exceeds the limit by {no_window:.3e}")
            if not no_window > 0:
                raise AssertionError(f"{label}: the library check does not "
                                     f"tell a missing window mask")
        bound, bound_by = attention_bound_ms(q, k, causal, window)
        lib_tol = (tol if dtype == f32
                   else f"{tol} + {LIB_P_RTOL} plain(|v|)")
        print(f"{tag} flash_attention {label}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (scaled_dot_product_attention, "
              f"max |library - plain| {lib_err:.3e}, tol {lib_tol}, "
              f"{lib_excess:.3e} past it) {library_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({bound_by}), "
              f"{attention_pairs(S, Skv, causal, window)} pairs per head, "
              f"L2 cold")
        rows.append({"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:98",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms})
    del flush
    return rows


def check_rglru_kernel(torch, R, card):
    """Phase 9: the RG-LRU scan kernel vs its plain version at the hybrid
    prefill's shape ``[1, 2 300, R]`` in bf16 and f32, and at an odd S, each
    timed beside the plain version. No single PyTorch call computes a
    linear recurrence, so there is no library yardstick. Returns the
    kernels-line entry of the bf16 prefill shape."""
    from repro_torch.kernels import rglru_ref, rglru_scan

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    entry = None
    for S, dtype in ((HYB_LONG_PROMPT, torch.bfloat16),
                     (HYB_LONG_PROMPT, torch.float32),
                     (1001, torch.bfloat16)):
        a = torch.sigmoid(torch.randn((1, S, R), generator=gen,
                                      device="cuda")).to(dtype)
        x = torch.randn((1, S, R), generator=gen, device="cuda").to(dtype)
        out = rglru_scan(a, x)
        ref = rglru_ref(a, x)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if dtype == torch.float32:
            ok, what = torch.equal(out, ref), "bitwise equal"
        else:
            wide = rglru_ref(a.float(), x.float()).to(dtype)
            ok = torch.equal(out, wide) and err <= TOL_RGLRU_BF16
            what = (f"bitwise equal to the f32-carry plain version; tol "
                    f"{TOL_RGLRU_BF16} against the bf16 carry")
        print(f"[9] rglru_scan B=1 S={S} R={R} {str(dtype)[6:]}: max_abs_err "
              f"{err:.3e} against the plain version ({what}); |plain| max "
              f"{float(ref.float().abs().max()):.3f}")
        if not (ok and torch.isfinite(out).all()):
            raise AssertionError(f"rglru_scan S={S} {dtype}: kernel and plain "
                                 f"version disagree")
        ms = cuda_ms(torch, lambda: rglru_scan(a, x), flush=flush)
        # the plain version is a host loop of ~3 S small launches (tens of
        # ms): a few calls time it well enough
        plain_ms = cuda_ms(torch, lambda: rglru_ref(a, x), n=5, warmup=1,
                           flush=flush)
        t_bytes = 3 * a.numel() * a.element_size() / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * a.numel() / PEAK_FLOPS["float32"] * 1e3
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[9] rglru_scan B=1 S={S} {str(dtype)[6:]}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}), "
              f"library none, L2 cold; {card}")
        if entry is None:
            entry = {"name": "rglru_scan", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                     "replaces": "src/repro/kernels/rglru_scan.py:49",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None}
    del flush
    return entry


def hybrid_layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, recurrent layers) of a hybrid config."""
    pat = cfg.block_pattern
    n_attn = sum(pat[i % len(pat)] == "attn" for i in range(cfg.n_layers))
    return n_attn, cfg.n_layers - n_attn


def hybrid_want(cfg, st) -> dict:
    """Launches a continuous hybrid drain must count: the flash kernel per
    attention layer and the scan per recurrent layer, per prefill."""
    n_attn, n_rec = hybrid_layer_counts(cfg)
    return {"flash_attention": n_attn * st["prefills"],
            "rglru_scan": n_rec * st["prefills"]}


def hybrid_workload(vocab):
    """8 seeded prompts: 7 of 17-400 tokens and, third in line, one of
    2 300 tokens, past the 2 048-position local window."""
    rng = np.random.default_rng(SEED + 10)
    lens = list(rng.integers(HYB_PROMPT_LENS[0], HYB_PROMPT_LENS[1] + 1,
                             size=HYB_REQUESTS - 1))
    lens.insert(2, HYB_LONG_PROMPT)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in lens]


@contextlib.contextmanager
def counting(module, name):
    """Count the calls of ``module.name`` while the block runs; yields a
    one-element list holding the count."""
    fn = getattr(module, name)
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def serve_continuous(torch, cfg, params, device, want_fn, what):
    """Phases 10 and 11: continuous serving of a full-width model on
    :func:`hybrid_workload`. Every wrapper must count ``want_fn(stats)``
    launches, and the plain WKV recurrence (both plain WKV versions run it)
    must not run at all. Returns (engine, prompts, streams, metrics); the
    prefill seconds are the card-synchronised time of each admission
    prefill, summed."""
    from repro_torch.kernels import ref
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, mode="continuous", capacity=HYB_CAPACITY,
                      max_batch=HYB_MAX_BATCH, decode_chunk=DECODE_CHUNK,
                      device=device)
    prefill, prefill_s = eng._prefill, []

    def timed_prefill(*args):
        t0 = time.perf_counter()
        out = prefill(*args)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    eng._prefill = timed_prefill
    prompts = hybrid_workload(cfg.vocab)
    with counting(ref, "_wkv_recurrence") as plain_wkv:
        streams, m = drain(torch, eng, prompts, HYB_MAX_NEW)
    eng._prefill = prefill
    m["prefill_s"] = sum(prefill_s)
    m["prompt_tokens"] = sum(map(len, prompts))
    m["plain_wkv_runs"] = plain_wkv[0]
    if any(len(s) != HYB_MAX_NEW for s in streams):
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        raise AssertionError("token out of the vocabulary")
    check_counts(what, m["counts"], want_fn(m))
    if plain_wkv[0]:
        raise AssertionError(f"{what}: the plain WKV recurrence ran "
                             f"{plain_wkv[0]} times on the card's path")
    return eng, prompts, streams, m


def replay_hybrid(torch, cfg, params, prompts, streams, attend, scan,
                  device, *, capacity=HYB_CAPACITY, max_new=HYB_MAX_NEW):
    """Teacher-forced per-step logits [n, max_new, V] (f32): each
    prompt's prefill through ``attend`` and ``scan`` into a slot cache,
    then the served tokens fed back through the slot decode, every slot at
    its own position."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batch import (init_slot_cache, slot_axes,
                                         write_slot)

    cache = init_slot_cache(cfg, len(prompts), capacity, device=device)
    axes = slot_axes(cfg, capacity)
    first = []
    for i, p in enumerate(prompts):
        lg, c = prefill(cfg, params, torch.as_tensor(p[None], device=device),
                        capacity, attend=attend, scan=scan)
        write_slot(cache, c, i, axes)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)]
    for t in range(max_new - 1):
        tok = torch.as_tensor([[s[t]] for s in streams], dtype=torch.int32,
                              device=device)
        lg, cache = decode_step(cfg, params, tok, cache)
        steps.append(lg[:, -1].float())
    return torch.stack(steps, dim=1)


def check_replay_hybrid(torch, cfg, params, prompts, streams, device):
    """Phase 10: the served streams replayed with both kernels and with
    both plain versions; the logits must agree, and each served token must
    be within the tolerance of the plain argmax logit."""
    from repro_torch.kernels import attention_ref, ops, rglru_ref

    ker = replay_hybrid(torch, cfg, params, prompts, streams, ops.attention,
                        ops.rglru, device)
    plain = replay_hybrid(torch, cfg, params, prompts, streams,
                          attention_ref, rglru_ref, device)
    diff = float((ker - plain).abs().max())
    served = torch.as_tensor(streams, device=device).long()
    served_logit = plain.gather(-1, served[..., None])[..., 0]
    gap = float((plain.max(-1).values - served_logit).max())
    agree = float((plain.argmax(-1) == served).float().mean())
    print(f"[10] replay over {len(prompts)} x {HYB_MAX_NEW} steps: max "
          f"|logits kernels - plain| {diff:.4f} (tol {TOL_REPLAY}); served "
          f"token within {gap:.4f} of the plain argmax logit (tol "
          f"{TOL_REPLAY}); argmax agreement {agree:.4f}; |logit| max "
          f"{float(plain.abs().max()):.3f}")
    if not torch.isfinite(ker).all() or diff > TOL_REPLAY \
            or gap > TOL_REPLAY:
        raise AssertionError("hybrid replay: the served streams disagree with "
                             "the plain versions beyond the bf16 tolerance")


def wkv_case(torch, gen, *, B, S, H, Dh, dtype, state):
    """r/k/v ``[B, S, H, Dh]`` in ``dtype``, the decay w (0.98 sigmoid of a
    normal draw, as the JAX package's kernel test draws it) in f32, u
    ``[H, Dh]`` and an initial state (or None), on the card."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (randn(B, S, H, Dh).to(dtype) for _ in range(3))
    w = 0.98 * torch.sigmoid(randn(B, S, H, Dh))
    return [r, k, v, w, 0.1 * randn(H, Dh),
            randn(B, H, Dh, Dh) if state else None]


def wkv_bound_ms(r, state: bool):
    """Least time for one WKV call: r, k, v (their dtype), w (f32), u, the
    initial state if given, y and the final state moved once over the HBM
    rate, or the f32 operations the function needs over the f32 peak,
    whichever is larger. Per step and (batch, head) those are 5 per state
    element (k v, w S and their sum; r S, a product and a sum) and 5 per
    channel (the bonus term is the scalar sum_i r_i u_i k_i times v, added
    to y)."""
    B, S, H, Dh = r.shape
    n = B * S * H * Dh
    esz = r.element_size()
    nbytes = (4 * esz * n + 4 * n + 4 * H * Dh
              + 4 * B * H * Dh * Dh * (2 if state else 1))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * n * (Dh + 1) / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chains_bitwise(torch, scan, args, split):
    """Whether a WKV scan of ``args`` (r, k, v, w, u, s0) whole equals its
    first ``split`` steps and then the rest from their final state, y and
    the final state bit for bit: the prefill-then-decode path."""
    r, k, v, w, u, s0 = args
    y, s_t = scan(*args)
    ya, sa = scan(*(t[:, :split] for t in (r, k, v, w)), u, s0)
    yb, sb = scan(*(t[:, split:] for t in (r, k, v, w)), u, sa)
    return torch.equal(torch.cat([ya, yb], dim=1), y) and torch.equal(sb, s_t)


def check_wkv_kernel(torch, cfg, card):
    """Phase 11a: the WKV scan kernel vs its plain version at the serving
    path's shapes — rwkv6-1.6b's prefill (B 1, a 2 300-token prompt, H 32,
    Dh 64) with bf16 and f32 inputs from a zero state, and its decode step
    (B 4, S 1) from a nonzero state — and at Dh 128 with an odd S, and
    through strided views; each timed beside the plain version. The bf16
    prefill is also scanned as 2 299 steps and then one decode step from
    their state, which must give the whole scan's bits. No single PyTorch
    call computes the recurrence, so there is no library yardstick.
    Returns the kernels-line entry of the bf16 prefill."""
    from repro_torch.kernels import wkv6_scan, wkv6_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    H, Dh = cfg.n_heads, cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, S, H, Dh, dtype, initial state, strided views)
    cases = [("prefill", 1, HYB_LONG_PROMPT, H, Dh, bf16, False, False),
             ("prefill f32", 1, HYB_LONG_PROMPT, H, Dh, f32, False, False),
             ("decode", HYB_MAX_BATCH, 1, H, Dh, bf16, True, False),
             ("Dh 128, S 37", 2, 37, 4, 128, f32, True, False),
             ("strided views", 2, 300, H, Dh, bf16, True, True)]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    entry = None
    for label, B, S, Hc, Dhc, dtype, state, strided in cases:
        args = wkv_case(torch, gen, B=B, S=S, H=Hc, Dh=Dhc, dtype=dtype,
                        state=state)
        if strided:
            # [B, H, S, Dh] tensors viewed as [B, S, H, Dh], and k as the
            # second half of a wider channel axis (a fused projection)
            args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
            args[1] = torch.cat([args[1], args[1]], -1)[..., Dhc:]
            args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
        y, s_t = wkv6_scan(*args)
        ry, rs = wkv6_scan_ref(*args)
        r, k, v, w, u, s0 = args
        mag, _ = wkv6_scan_ref(r.float().abs(), k.float().abs(),
                               v.float().abs(), w, u.abs(),
                               None if s0 is None else s0.abs())
        torch.cuda.synchronize()
        diff = (y.float() - ry.float()).abs()
        err = float(diff.max())
        if dtype == f32:
            lim, tol = TOL_F32 + WKV_UNITS * mag, f"{TOL_F32}"
        else:
            lim = BF16_ATOL + BF16_RTOL * ry.float().abs() + WKV_UNITS * mag
            tol = f"{BF16_ATOL} + {BF16_RTOL} |plain|"
        excess = float((diff - lim).max())
        print(f"[11a] wkv6_scan {label}: B={B} S={S} H={Hc} Dh={Dhc} "
              f"{str(dtype)[6:]} from {'S0' if state else 'zeros'}: "
              f"max_abs_err {err:.3e} (tol {tol} + {WKV_UNITS:.3g} M, "
              f"{excess:.3e} past it; |plain| max "
              f"{float(ry.float().abs().max()):.3f}, M max "
              f"{float(mag.max()):.3f}); y bitwise equal "
              f"{torch.equal(y, ry)}, final state bitwise equal "
              f"{torch.equal(s_t, rs)}")
        if not (torch.isfinite(y).all() and excess <= 0
                and torch.equal(s_t, rs)):
            raise AssertionError(f"wkv6_scan {label}: kernel and plain "
                                 f"version disagree")
        if label == "prefill":
            chained = chains_bitwise(torch, wkv6_scan, args, S - 1)
            print(f"[11a] wkv6_scan {label}: {S} steps whole against {S - 1} "
                  f"steps then one decode step from their state: y and "
                  f"final state bitwise equal {chained}")
            if not chained:
                raise AssertionError("wkv6_scan: the prefill-then-decode "
                                     "chain differs from the whole scan")
        ms = cuda_ms(torch, lambda: wkv6_scan(*args), flush=flush)
        # the plain version is a host loop of ~8 launches a step: at a
        # prompt's length a few calls time it well enough
        plain_ms = cuda_ms(torch, lambda: wkv6_scan_ref(*args),
                           n=3 if S > 100 else 50,
                           warmup=1 if S > 100 else 5, flush=flush)
        bound, bound_by = wkv_bound_ms(r, state)
        print(f"[11a] wkv6_scan {label}: {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound:.5f} ms ({bound_by}), library none, "
              f"L2 cold; {card}")
        if entry is None:
            entry = {"name": "wkv6_scan", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/wkv6_scan.cu",
                     "replaces": "src/repro/kernels/wkv6_scan.py:55",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None}
    del flush
    return entry


def ssm_want(cfg, st) -> dict:
    """Launches a continuous rwkv6 drain must count: the WKV kernel once
    per layer per prefill and per decode step."""
    return {"wkv6_scan": cfg.n_layers * (st["prefills"] + st["decode_steps"])}


class WkvReplay:
    """The replay's WKV dispatch: each call runs the kernel, whose output
    the model goes on with, and its f32 output on the same values is kept.
    :meth:`check` then holds the kept calls (every layer of one prefill, or
    of one decode step) against the plain version, and the plain version
    against the recurrence in f64, under the error model above
    (``WKV_UNITS``): one batched pass over the layers, since no call's
    inputs depend on another call's comparison."""

    def __init__(self, torch):
        self.torch = torch
        self.pending = []
        self.calls = 0
        self.max_err = 0.0        # max |kernel - plain|, f32 y
        self.max_err_units = 0.0  # the same, in units of 2**-24 M
        self.max_noise_units = 0.0  # max |plain - f64|, 2**-24 M units

    def __call__(self, r, k, v, w, u, s0):
        from repro_torch.kernels import wkv6_scan

        torch = self.torch
        y, s_t = wkv6_scan(r, k, v, w, u, s0)
        # s0 is a view of the slot cache, which decode overwrites with s_t
        wide = [t.float() for t in (r, k, v)] + [
            w, u, None if s0 is None else s0.clone()]
        ky, ks = wkv6_scan(*wide)
        if not (torch.equal(ky.to(y.dtype), y) and torch.equal(ks, s_t)):
            raise AssertionError("wkv6_scan: the kernel's f32 output differs "
                                 "from its output in the model's dtype")
        self.pending.append((wide, ky, ks))
        return y, s_t

    def check(self):
        """Hold the kept calls to the plain version and to f64."""
        from repro_torch.kernels import ref, wkv6_scan_ref

        torch = self.torch
        calls, self.pending = self.pending, []
        self.calls += len(calls)
        B, _, H, Dh = calls[0][0][0].shape
        n_calls = len(calls)

        def stack(i):          # the calls' i-th input, batched: [n B, ...]
            if calls[0][0][i] is None:
                return None
            return torch.cat([c[0][i] for c in calls])

        r, k, v, w, s0 = (stack(i) for i in (0, 1, 2, 3, 5))
        u = torch.stack([c[0][4] for c in calls])       # each call's u
        u = u.repeat_interleave(B, dim=0)               # [n B, H, Dh]
        ky = torch.cat([c[1] for c in calls]).double()
        ks = torch.cat([c[2] for c in calls])
        py, ps = wkv6_scan_ref(r, k, v, w, u, s0)
        if not torch.equal(ks, ps):
            raise AssertionError("wkv6_scan: the kernel's final state differs "
                                 "from the plain version's")
        # the recurrence in f64 on the inputs and, batched beside them, on
        # their magnitudes: the reference y and the terms' magnitude M
        nb = n_calls * B
        state = (torch.zeros((nb, H, Dh, Dh), dtype=torch.float64,
                             device=r.device) if s0 is None else s0.double())
        both = [torch.cat([t.double(), t.double().abs()]).transpose(1, 2)
                for t in (r, k, v, w)]
        ud = u.double()
        y64, _ = ref._wkv_recurrence(*both, torch.cat([ud, ud.abs()]),
                                     torch.cat([state, state.abs()]))
        y64 = y64.transpose(1, 2)
        exact, mag = y64[:nb], y64[nb:]
        unit = 2.0 ** -24 * mag.clamp_min(1e-30)
        err = (ky - py.double()).abs()
        noise = (py.double() - exact).abs()
        self.max_err = max(self.max_err, float(err.max()))
        self.max_err_units = max(self.max_err_units, float((err / unit).max()))
        self.max_noise_units = max(self.max_noise_units,
                                   float((noise / unit).max()))


def check_replay_ssm(torch, cfg, params, prompts, streams, device):
    """Phase 11: the served streams replayed teacher-forced — each prompt's
    prefill into a slot cache, then the served tokens fed back through the
    slot decode — with every WKV call held, layer by layer, to the plain
    version under the stated error model; the logits must be finite, and
    the served tokens' agreement with the replay's argmax is reported."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batch import (init_slot_cache, slot_axes,
                                         write_slot)

    wkv = WkvReplay(torch)
    cache = init_slot_cache(cfg, len(prompts), HYB_CAPACITY, device=device)
    axes = slot_axes(cfg, HYB_CAPACITY)
    first = []
    for i, p in enumerate(prompts):
        lg, c = prefill(cfg, params, torch.as_tensor(p[None], device=device),
                        HYB_CAPACITY, wkv=wkv)
        wkv.check()
        write_slot(cache, c, i, axes)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)]
    for t in range(HYB_MAX_NEW - 1):
        tok = torch.as_tensor([[s[t]] for s in streams], dtype=torch.int32,
                              device=device)
        lg, cache = decode_step(cfg, params, tok, cache, wkv=wkv)
        wkv.check()
        steps.append(lg[:, -1].float())
    logits = torch.stack(steps, dim=1)
    served = torch.as_tensor(streams, device=device).long()
    gap = float((logits.max(-1).values
                 - logits.gather(-1, served[..., None])[..., 0]).max())
    agree = float((logits.argmax(-1) == served).float().mean())
    want = cfg.n_layers * (len(prompts) + HYB_MAX_NEW - 1)
    limit = WKV_UNITS * 2 ** 24
    print(f"[11] replay over {len(prompts)} x {HYB_MAX_NEW} steps, "
          f"{wkv.calls} WKV calls: max |y kernel - plain| {wkv.max_err:.3e} "
          f"(f32), {wkv.max_err_units:.2f} units of 2^-24 M (limit "
          f"{limit:g}); rounding noise max |y plain - f64| "
          f"{wkv.max_noise_units:.2f} units (limit {limit / 2:g}, 2x "
          f"headroom); served token within {gap:.4f} of the replay's "
          f"argmax logit, argmax agreement {agree:.4f}; |logit| max "
          f"{float(logits.abs().max()):.3f}")
    if wkv.calls != want or not torch.isfinite(logits).all():
        raise AssertionError(f"ssm replay: {wkv.calls} WKV calls (want "
                             f"{want}) or non-finite logits")
    if wkv.max_err_units > limit or wkv.max_noise_units > limit / 2:
        raise AssertionError("ssm replay: the kernel's WKV output departs "
                             "from the plain version's beyond the error "
                             "model, or the rounding noise leaves the limit "
                             "less than 2x headroom")


def bilevel_build(K):
    """The §6 workload at K nodes: (problem, cfg, sampler factory, topology,
    eval batch)."""
    from repro_torch.core import HypergradConfig, logreg_hyperopt, ring
    from repro_torch.data import (NodeSampler, make_classification,
                                  shard_to_nodes, train_val_split)

    ds = make_classification(n=BL_N, d=BL_D, c=2, seed=SEED)
    tr, va = train_val_split(ds, 0.3, seed=SEED)
    trn, van = shard_to_nodes(tr, K), shard_to_nodes(va, K)

    def sampler():
        return NodeSampler(trn, van, batch=max(BL_BATCH_TOTAL // K, 1),
                           J=BL_J, seed=SEED)

    prob = logreg_hyperopt(d=BL_D, c=2, lip_gy=BL_LIP)
    cfg = HypergradConfig(J=BL_J, lip_gy=BL_LIP, randomize=True)
    return prob, cfg, sampler, ring(K), sampler().eval_batch()


def bilevel_engine(torch, algo, K, device, dispatch, mix="dense",
                   mix_kwargs=None, recorder=None):
    from repro_torch.core import Engine, HParams

    prob, cfg, sampler, topo, eval_batch = bilevel_build(K)
    eta, a1, a2, b1, b2 = BL_HP[algo]
    eng = Engine(prob, cfg, HParams(eta, a1, a2, b1, b2), topo, algo=algo,
                 mix=mix, dispatch=dispatch, mix_kwargs=mix_kwargs,
                 recorder=recorder, device=device)
    return eng, sampler, eval_batch


def timed_run(torch, eng, sampler, eval_batch, steps, **kw):
    """One run to its end on the card: (result, final state, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, state = eng.run(sampler, eval_batch, steps=steps,
                         eval_every=BL_EVAL, return_state=True, **kw)
    torch.cuda.synchronize()
    return res, state, time.perf_counter() - t0


def check_finite_falls(torch, tag, res, state, K=BL_K):
    """Finite losses and state of the expected shapes, and an upper loss
    that falls from its start."""
    if not all(bool(torch.isfinite(t).all()) for t in state):
        raise AssertionError(f"{tag}: non-finite state")
    if state.x.shape != (K, BL_D) or state.y.shape != (K, BL_D, 2):
        raise AssertionError(f"{tag}: state shapes {state.x.shape}, "
                             f"{state.y.shape}")
    curve = res.upper_loss
    if not all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise AssertionError(f"{tag}: the upper loss did not fall: {curve}")


def states_equal(torch, a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def same_curves(a, b, upto=None) -> bool:
    """``a``'s eval records equal ``b``'s first ``upto`` (all) bit for bit."""
    return all(getattr(a, k) == getattr(b, k)[:upto] for k in (
        "steps", "upper_loss", "lower_loss", "consensus_x", "consensus_y"))


class BusyWindow:
    """The card's busy time and the wall time (ms) from ``start()`` to
    ``stop()`` under the profiler, and the device records in between: the
    spin burst and idle tail frame the window as in the profiled
    drains."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()
        spin_burst(self.torch)
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        time.sleep(TRACE_TAIL_S)
        self.prof.stop()
        recs = [(n, d) for n, d in device_records(self.torch, self.prof)
                if TRACE_SPIN not in n]
        busy_ms = sum(d for _, d in recs) / 1e6
        if busy_ms <= 0:
            raise AssertionError("the profiler recorded no time on the card")
        return busy_ms, wall_ms, len(recs)


def check_whisper_trainer(torch, card):
    """Phase 17: the LM trainer on full-width ``whisper-tiny`` through its
    CLI, per_step for one eval interval, then fused (one capture, two
    replays): the states after it equal bit for bit, the evals finite and
    equal; steps/s of both, the peak memory, the busy share over one
    replayed chunk."""
    from repro_torch.configs import get
    from repro_torch.core.hypergrad import tree_map
    from repro_torch.launch import train as train_cli
    from repro_torch.train import TrainerConfig
    from torch.utils import _pytree as pytree

    dev = torch.device("cuda")
    cfg = get(WH_ARCH).config
    to_cpu = partial(tree_map, lambda a: a.cpu())
    gb = 1e-9
    summary = {"card": card, "arch": WH_ARCH, "K": TR_K,
               "tokens_per_node_step": TR_BATCH * TR_SEQ,
               "src_frames": cfg.src_len}
    kept = {}

    def keeper(key):
        def on_eval(t, state):
            if t == 0:
                summary["params_per_node"] = sum(
                    a.numel() for a in pytree.tree_leaves(state.y)) // TR_K
            elif t == TR_EVAL:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kept[key] = to_cpu(state)
                kept[f"{key}_s"] = time.perf_counter() - t0
            elif t == TR_STEPS:
                kept["live"] = state
        return on_eval

    torch.cuda.reset_peak_memory_stats()
    pres, peng = train_cli.main(
        ["--arch", WH_ARCH, "--steps", str(TR_EVAL), "--eval-every",
         str(TR_EVAL), "--dispatch", "per_step"], on_eval=keeper("per_step"))
    torch.cuda.synchronize()
    summary["per_step"] = {
        "steps_per_s": round(TR_EVAL / (pres.wall_time_s
                                        - kept["per_step_s"]), 3),
        "peak_gb": round(torch.cuda.max_memory_allocated() * gb, 2)}
    del peng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, eng = train_cli.main(WT_ARGV, on_eval=keeper("fused"))
    torch.cuda.synchronize()
    curves = res.upper_loss + res.lower_loss
    if not (all(np.isfinite(curves)) and res.steps == [0, TR_EVAL, TR_STEPS]
            and (eng.captures, eng.replays) == (1, 2)):
        raise AssertionError(f"[17] {res.steps}, losses {curves}, "
                             f"{eng.captures} captures, {eng.replays} replays")
    if not (leaves_equal(torch, kept["fused"], kept["per_step"])
            and same_curves(pres, res, upto=2)):
        raise AssertionError("[17] fused differs from per_step at full "
                             "width")
    wall = res.wall_time_s - kept["fused_s"]
    summary["fused_cli"] = {
        "steps_per_s": round(TR_STEPS / wall, 3),
        "wall_s": round(wall, 2), "capture_s": round(eng.capture_s, 2),
        "peak_gb": round(torch.cuda.max_memory_allocated() * gb, 2),
        "val_loss": [round(v, 4) for v in res.upper_loss]}
    print(f"[17] fused == per_step bit for bit after {TR_EVAL} steps "
          f"(every state leaf) and at the evals of steps 0 and {TR_EVAL}",
          flush=True)
    tc = TrainerConfig(mix="ring")     # the CLI's algorithm and J
    draws = trainer_draws(torch, cfg, tc, dev, TR_EVAL)
    busy, wall_ms, n = busy_share(torch, lambda: eng.run_chunk(
        kept["live"], draws))
    summary["fused_replay"] = {
        "steps_per_s": round(TR_EVAL / (wall_ms / 1e3), 3),
        "busy_share": round(busy / wall_ms, 4), "busy_ms": round(busy, 1),
        "wall_ms": round(wall_ms, 1), "device_records_per_step": n // TR_EVAL}
    print("[17] " + json.dumps(summary), flush=True)
    del eng, kept
    torch.cuda.empty_cache()
    return summary


def dry_run_worker(archs, train_shape, reduced=False) -> dict:
    """Phase 18's dry runs, in a worker process of its own (CPU, one
    intra-op thread; no card): ``run_pair`` of each arch's trainer step at
    ``train_shape`` on the one-card mesh, its JSON under ``build/dryrun``."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import run_pair
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import TrainerConfig

    return {arch: run_pair(arch, mesh=make_debug_mesh(data=1, model=1),
                           tc=TrainerConfig(mix="ring"),
                           train_shape=tuple(train_shape), reduced=reduced,
                           tag="reduced" if reduced else "", verbose=False)
            for arch in archs}


def forward_flops(cfg, B, S) -> int:
    """The matrix products of one ``loss_fn`` forward of a dense or audio
    ``cfg`` on ``B`` rows of ``S`` tokens, 2·m·n·k each: the projections
    and the MLP per token, the attention's two products over every (query,
    key) pair (the einsum attention computes the masked ones too), the
    one-hot embedding and the logits (V·D a token each); whisper's encoder
    over ``src_len`` frames and every decoder layer's cross-attention."""
    D, H, Hkv, Dh, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab)
    T = B * S
    mlp = (3 if cfg.act == "swiglu" else 2) * D * F
    proj = 2 * D * H * Dh + 2 * D * Hkv * Dh
    total = (cfg.n_layers * (2 * T * (proj + mlp) + 4 * B * H * S * S * Dh)
             + 2 * 2 * T * V * D)
    if cfg.is_encdec:
        Ts = B * cfg.src_len
        total += cfg.n_enc_layers * (2 * Ts * (proj + mlp)
                                     + 4 * B * H * cfg.src_len ** 2 * Dh)
        total += cfg.n_layers * (2 * T * 2 * D * H * Dh
                                 + 2 * Ts * 2 * D * Hkv * Dh
                                 + 4 * B * H * S * cfg.src_len * Dh)
    return total


def dry_step_check(torch, cfg, dry, K, per_node, seq, tag,
                   replays=DRY_REPLAYS) -> dict:
    """Phase 18 (a)/(b): the trainer's step of ``cfg`` (MDBO, the ring mix,
    J = 2) on the card at the dry run's shape, held to the dry run
    ``dry``: the state's, step batch's and J̃'s bytes equal to its
    ``argument_bytes``; a ``FlopCounterMode`` count of one per_step step
    equal to its flops, and to :func:`forward_flops` through the pass
    factor (``DRY_FACTOR_RTOL``); the card's peak over that step (after
    ``reset_peak_memory_stats``, less what the process held before this
    check began: earlier phases' caches and the cuBLAS workspaces) within
    ``DRY_PEAK_RTOL`` of its peak; the median of ``replays`` replays of a
    one-step CUDA graph no faster than its ``t_compute``. Returns the
    numbers."""
    from repro_torch.core.common import replicate
    from repro_torch.core.engine import _unaliased
    from repro_torch.data import make_lm_step_batch
    from repro_torch.models import loss_fn
    from repro_torch.train import TrainerConfig, make_trainer_engine
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tc = TrainerConfig(mix="ring")
    problem, eng = make_trainer_engine(cfg, tc, K, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)

    def draw():
        return (make_lm_step_batch(cfg, gen, K, per_node, seq, J=tc.J),
                torch.randint(0, tc.J, (K,), generator=gen, device=dev))

    x0, y0 = problem.init_x(gen, dev), problem.init_y(gen, dev)
    # the init state holds u, zf (and v, zg) as one tensor each; a step's
    # state, which the dry run counts, holds each leaf on its own
    state = _unaliased(eng.init(replicate(x0, K), replicate(y0, K), *draw()))
    del x0, y0
    batch, jt = draw()
    got_args = sum(t.nbytes for t in pytree.tree_leaves((state, batch, jt)))
    want_args = dry["global"]["argument_bytes"]
    if got_args != want_args or dry["memory"]["argument_bytes"] != want_args:
        raise AssertionError(f"{tag} argument bytes: the card holds "
                             f"{got_args}, the dry run counts {want_args} "
                             f"(per device {dry['memory']['argument_bytes']})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        new = eng.step(state, batch, jt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    flops = counter.get_total_flops()
    del new
    if flops != dry["global"]["flops"]:
        raise AssertionError(f"{tag} flops: the card's step counts {flops}, "
                             f"the dry run {dry['global']['flops']}")
    with FlopCounterMode(display=False) as counter:
        loss_fn(cfg, *pytree.tree_map(lambda t: t[0], (state.y, batch["f"])))
    fwd, want_fwd = counter.get_total_flops(), forward_flops(cfg, per_node,
                                                             seq)
    if fwd != want_fwd:
        raise AssertionError(f"{tag} a node's forward counts {fwd} flops, "
                             f"its matrix products {want_fwd}")
    factor, want_factor = flops / (K * want_fwd), 9 + 9 * tc.J
    if abs(factor / want_factor - 1) > DRY_FACTOR_RTOL:
        raise AssertionError(f"{tag} the step counts {factor:.4f} forwards "
                             f"a node, not {want_factor} within "
                             f"{DRY_FACTOR_RTOL}")
    want_peak = dry["global"]["peak_bytes"]
    if abs(want_peak - peak) > DRY_PEAK_RTOL * peak:
        raise AssertionError(f"{tag} peak: predicted {want_peak} B against "
                             f"the card's {peak} B (ratio "
                             f"{want_peak / peak:.4f}, limit "
                             f"{DRY_PEAK_RTOL})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    carry, _ = eng.run_chunk(state, [(batch, jt)])     # captures, replays
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    times = []
    for _ in range(replays):
        t0 = time.perf_counter()
        carry, _ = eng.run_chunk(carry, [(batch, jt)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    rl = dry["roofline"]
    bound = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
    if step_s < rl["t_compute_s"]:
        raise AssertionError(f"{tag} a replayed step took {step_s} s, below "
                             f"the compute bound {rl['t_compute_s']} s: the "
                             f"flop count is wrong")
    del eng, state, carry, batch, jt
    torch.cuda.empty_cache()
    return {"argument_bytes": got_args, "flops": flops,
            "forward_flops": want_fwd, "forwards_per_node": factor,
            "peak_bytes": {"predicted": want_peak, "card": peak,
                           "ratio": want_peak / peak},
            "t_compute_s": rl["t_compute_s"], "t_memory_s": rl["t_memory_s"],
            "bound_s": bound, "bound_by": rl["dominant"],
            "replayed_step_s": step_s, "replays_s": times,
            "bound_over_measured": bound / step_s,
            "traffic_bytes": dry["global"]["traffic_bytes"],
            "capture_s": capture_s, "trace_s": dry["trace_s"],
            "useful_ratio": dry["useful_ratio"]}


def optim_check(torch, steps=OPT_STEPS) -> float:
    """Phase 18 (c): ``adamw`` after ``clip_by_global_norm`` for ``steps``
    steps on a CUDA tree and on its CPU copy, on the same gradients; the
    largest difference of a leaf relative to its largest magnitude, which
    must stay within ``OPT_RTOL``."""
    from repro_torch.optim import adamw, clip_by_global_norm
    from torch.utils import _pytree as pytree

    gen = torch.Generator().manual_seed(SEED + 18)
    params = {"w": torch.randn(256, 384, generator=gen),
              "b": torch.randn(384, generator=gen),
              "emb": {"table": torch.randn(1000, 96, generator=gen)}}
    grads = [pytree.tree_map(lambda p: 3.0 * torch.randn(
        p.shape, generator=gen), params) for _ in range(steps)]
    init, update = adamw()
    out = {}
    for dev in ("cpu", "cuda"):
        p = pytree.tree_map(lambda a: a.to(dev), params)
        st = init(p)
        for g in grads:
            g = clip_by_global_norm(pytree.tree_map(lambda a: a.to(dev), g),
                                    1.0)
            ups, st = update(g, st, p, 1e-2)
            p = pytree.tree_map(lambda a, u: a + u, p, ups)
        out[dev] = pytree.tree_leaves(p) + pytree.tree_leaves(st.mu) + \
            pytree.tree_leaves(st.nu)
    rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(out["cuda"], out["cpu"]))
    if not rel <= OPT_RTOL:
        raise AssertionError(f"[18c] adamw on the card departs from the CPU "
                             f"by {rel:.3g} relative (limit {OPT_RTOL})")
    return rel


def check_dry_run(torch, card, dry):
    """Phase 18: (a) smollm-360m and (b) whisper-tiny, each trainer step
    held to its dry run (:func:`dry_step_check`); (c) :func:`optim_check`.
    Prints each workload's bound beside its replayed step."""
    from repro_torch.configs import get

    summary = {"card": card}
    for arch, tag in zip(DRY_ARCHS, ("[18a]", "[18b]")):
        t0 = time.perf_counter()
        r = dry_step_check(torch, get(arch).config, dry[arch], TR_K,
                           TR_BATCH, TR_SEQ, tag)
        summary[arch] = r
        print(f"{tag} {arch}: argument bytes {r['argument_bytes']} and "
              f"flops {r['flops']} equal to the dry run's, "
              f"{r['forwards_per_node']:.4f} forwards of "
              f"{r['forward_flops']} a node (9 + 9 J = 27); peak predicted "
              f"{r['peak_bytes']['predicted']} B, the card's "
              f"{r['peak_bytes']['card']} B (ratio "
              f"{r['peak_bytes']['ratio']:.4f}); t_compute "
              f"{r['t_compute_s']:.6f} s, t_memory {r['t_memory_s']:.6f} s, "
              f"bound {r['bound_s']:.6f} s ({r['bound_by']}), replayed step "
              f"{r['replayed_step_s']:.6f} s, bound / measured "
              f"{r['bound_over_measured']:.4f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    summary["optim_rel_err"] = optim_check(torch)
    print(f"[18c] adamw + clip_by_global_norm, {OPT_STEPS} steps: the card "
          f"within {summary['optim_rel_err']:.3g} of the CPU (limit "
          f"{OPT_RTOL})")
    print("[18] " + json.dumps(summary), flush=True)
    return summary


def busy_share(torch, fn):
    """:class:`BusyWindow` over one call of ``fn``: (busy ms, wall ms,
    device records)."""
    window = BusyWindow(torch)
    window.start()
    fn()
    return window.stop()


def check_bilevel(torch, card):
    """Phase 12: the paper's decentralized bilevel run on the card.

    (a) fig1: the four paper algorithms, fused, 60 steps (six CUDA graph
    replays from one capture each); the upper loss must fall; (b) MDBO and
    VRDBO per_step against fused from the same seed, bit for bit: on the
    dense mix against (a)'s own run at its first eval, on ``ring_rolled``
    over two 5-step chunks; (c) the card's per_step runs against the port's
    CPU run of the same workload and J̃; (e) MDBO at K = 16 (fig3), and
    (a)'s MDBO engine through the device sampler (the JAX package's
    ``engine_bench.py`` path), whose batch layout reuses its graph. Then
    the card's busy share over one 10-step chunk of each dispatch."""
    from repro_torch.core.hypergrad import tree_map
    from repro_torch.data import make_device_sampler

    dev = torch.device("cuda")
    jt = np.random.default_rng(SEED).integers(
        0, BL_J, (BL_FIG1_STEPS + 1, BL_K))
    chunks = BL_FIG1_STEPS // BL_EVAL
    rate = {}
    fig1 = {}
    t0 = time.perf_counter()
    for algo in ("dsbo", "gdsbo", "mdbo", "vrdbo"):
        eng, sampler, ev = bilevel_engine(torch, algo, BL_K, dev, "fused")
        kept = {}
        res, state, sec = timed_run(
            torch, eng, sampler(), ev, BL_FIG1_STEPS, jtilde=jt,
            on_eval=lambda t, s: kept.setdefault(t, tree_map(torch.clone, s)))
        check_finite_falls(torch, f"[12a] {algo}", res, state)
        if (eng.captures, eng.replays) != (1, chunks):
            raise AssertionError(f"[12a] {algo}: {eng.captures} captures, "
                                 f"{eng.replays} replays for {chunks} chunks")
        fig1[algo] = (eng, res, kept, state, sampler, ev)
        print(f"[12a] fig1 {algo}: upper loss {res.upper_loss[0]:.4f} -> "
              f"{res.upper_loss[-1]:.4f}, consensus x {res.consensus_x[-1]:.3g}"
              f", y {res.consensus_y[-1]:.3g}; {BL_FIG1_STEPS} steps, "
              f"{eng.replays} replays of one capture, {sec:.2f} s")
    print(f"[12a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for algo in ("mdbo", "vrdbo"):
        # steps/s of whole runs (init and evals included), the graph cached
        eng, res, kept, _, sampler, ev = fig1[algo]
        for steps in (BL_EVAL, BL_FIG1_STEPS):
            _, _, sec = timed_run(torch, eng, sampler(), ev, steps,
                                  jtilde=jt[:steps + 1])
            rate[(algo, f"fused, {steps} steps")] = steps / sec
        # (b) dense: per_step against (a)'s fused run, to its first eval
        peng, psampler, pev = bilevel_engine(torch, algo, BL_K, dev,
                                             "per_step")
        rp, sp, sec = timed_run(torch, peng, psampler(), pev, BL_EVAL,
                                jtilde=jt[:BL_EVAL + 1])
        rate[(algo, f"per_step, {BL_EVAL} steps")] = BL_EVAL / sec
        if not (states_equal(torch, sp, kept[BL_EVAL])
                and same_curves(rp, res, upto=2)):
            raise AssertionError(f"[12b] {algo}/dense: fused differs from "
                                 "per_step")
        # (b) ring_rolled: two 5-step chunks, fused against per_step
        half = BL_EVAL // 2
        out = {}
        for dispatch in ("per_step", "fused"):
            e, esampler, eev = bilevel_engine(torch, algo, BL_K, dev,
                                              dispatch, "ring_rolled")
            out[dispatch] = e.run(esampler(), eev, steps=BL_EVAL,
                                  eval_every=half, return_state=True,
                                  jtilde=jt[:BL_EVAL + 1])
        (rr, sr), (rf, sf) = out["per_step"], out["fused"]
        if not (states_equal(torch, sr, sf) and same_curves(rr, rf)
                and (e.captures, e.replays) == (1, 2)):
            raise AssertionError(f"[12b] {algo}/ring_rolled: fused differs "
                                 "from per_step")
        print(f"[12b] {algo}: fused == per_step bit for bit, dense over "
              f"{BL_EVAL} steps (one replay), ring_rolled over {BL_EVAL} "
              f"steps (two replays)")
        # (c) the card against the port's own CPU run
        ceng, csampler, cev = bilevel_engine(torch, algo, BL_K, "cpu",
                                             "per_step")
        rc, sc = ceng.run(csampler(), cev, steps=BL_EVAL, eval_every=BL_EVAL,
                          return_state=True, jtilde=jt[:BL_EVAL + 1])
        loss_err = max(abs(a - b) for a, b in zip(
            rp.upper_loss + rp.lower_loss, rc.upper_loss + rc.lower_loss))
        param_err = max(float((sp.x.cpu() - sc.x).abs().max()),
                        float((sp.y.cpu() - sc.y).abs().max()))
        print(f"[12c] {algo}: card vs CPU over {BL_EVAL} steps, max |loss "
              f"diff| {loss_err:.3g} (limit {TOL_BL_LOSS}), max |x, y diff| "
              f"{param_err:.3g} (limit {TOL_BL_PARAM})")
        if not (loss_err <= TOL_BL_LOSS and param_err <= TOL_BL_PARAM):
            raise AssertionError(f"[12c] {algo}: the card departs from the "
                                 "CPU")
    print(f"[12b, 12c] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # (e) fig3's K = 16
    eng, sampler, ev = bilevel_engine(torch, "mdbo", 2 * BL_K, dev, "fused")
    res, state, sec = timed_run(torch, eng, sampler(), ev, 2 * BL_EVAL)
    check_finite_falls(torch, "[12e] K=16", res, state, 2 * BL_K)
    print(f"[12e] mdbo K=16 fused: upper loss {res.upper_loss[0]:.4f} -> "
          f"{res.upper_loss[-1]:.4f}, {eng.replays} replays, {sec:.2f} s "
          "with the capture")
    # (e) the device sampler through (a)'s MDBO engine and its graph
    eng, res, _, state, sampler, ev = fig1["mdbo"]
    dsamp = make_device_sampler(sampler().tr, sampler().va,
                                batch=BL_BATCH_TOTAL // BL_K, J=BL_J,
                                device=dev)
    replays = eng.replays
    dres, dstate, sec = timed_run(torch, eng, dsamp, ev, BL_FIG1_STEPS)
    check_finite_falls(torch, "[12e] device sampler", dres, dstate)
    if (eng.captures, eng.replays - replays) != (1, chunks):
        raise AssertionError("[12e] the device sampler's run did not reuse "
                             "the cached graph")
    rate[("mdbo", f"fused, {BL_FIG1_STEPS} steps, device sampler")] = (
        BL_FIG1_STEPS / sec)
    print(f"[12e] mdbo fused, device sampler: upper loss "
          f"{dres.upper_loss[0]:.4f} -> {dres.upper_loss[-1]:.4f}, steps/s "
          f"{BL_FIG1_STEPS / sec:.1f} (graph cached)")
    # the card's busy share over one chunk of each dispatch (mdbo, dense),
    # its batches and J̃ already on the card
    smp = sampler()
    draws = [({k: {f: t.to(dev) for f, t in v.items()}
               for k, v in smp.sample().items()},
              torch.from_numpy(jt[i + 1]).to(dev)) for i in range(BL_EVAL)]

    def per_step():
        s = state
        for batch, jtilde in draws:
            s = eng.step(s, batch, jtilde)

    for dispatch, fn in (("per_step", per_step),
                         ("fused", lambda: eng.run_chunk(state, draws))):
        busy, wall, n = busy_share(torch, fn)
        print(f"[12] one {BL_EVAL}-step mdbo chunk, {dispatch}: wall "
              f"{wall:.2f} ms, card busy {busy:.2f} ms ({busy / wall:.1%}),"
              f" {n} device records")
    print(f"[12e, busy] took {time.perf_counter() - t0:.1f} s")
    print("[12] steps/s on " + card + ": " + json.dumps(
        {f"{a}/{d}": round(r, 2) for (a, d), r in rate.items()}))


def trainer_inputs(torch, cfg, tc, device, K=TR_K):
    """What ``repro_torch.launch.train`` builds around its engine from its
    defaults and ``--seed 0``: the device LM sampler and the eval batch."""
    from repro_torch.data import make_device_lm_sampler, make_node_batch

    return (make_device_lm_sampler(cfg, tc, K, TR_BATCH, TR_SEQ),
            make_node_batch(cfg, torch.Generator(device=device).manual_seed(
                SEED + 17), TR_BATCH, TR_SEQ))


def trainer_draws(torch, cfg, tc, device, n):
    """``n`` steps' (batch, J̃) drawn on the card, for the profiled chunks."""
    from repro_torch.data import make_lm_step_batch

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    return [(make_lm_step_batch(cfg, gen, TR_K, TR_BATCH, TR_SEQ, J=tc.J),
             torch.randint(0, tc.J, (TR_K,), generator=gen, device=device))
            for _ in range(n)]


def leaves_equal(torch, a, b) -> bool:
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


def small_batches(torch, arch):
    """Phase 13 (c)'s inputs for ``arch``'s reduced config, drawn on the
    CPU from the seed: (cfg, the step batches, the eval batch, J̃)."""
    from repro_torch.configs import get
    from repro_torch.data import make_lm_step_batch, make_node_batch

    cfg = get(arch).reduced()
    gen = torch.Generator().manual_seed(SEED)
    batches = [make_lm_step_batch(cfg, gen, TR_SMALL_K, TR_BATCH,
                                  TR_SMALL_SEQ, J=2)
               for _ in range(TR_SMALL_STEPS + 1)]
    ev = make_node_batch(cfg, gen, TR_BATCH, TR_SMALL_SEQ)
    jt = np.random.default_rng(SEED).integers(
        0, 2, (TR_SMALL_STEPS + 1, TR_SMALL_K))
    return cfg, batches, ev, jt


def small_run(torch, arch, algo, device, dispatch):
    """Phase 13 (c)'s run of ``arch`` on ``device``: (RunResult, state)."""
    from repro_torch.train import TrainerConfig, make_trainer_engine

    cfg, batches, ev, jt = small_batches(torch, arch)
    _, eng = make_trainer_engine(cfg, TrainerConfig(algo=algo, mix="ring"),
                                 TR_SMALL_K, dispatch=dispatch, device=device)
    it = iter(batches)
    return eng.run(lambda g: next(it), ev, steps=TR_SMALL_STEPS, seed=SEED,
                   eval_every=TR_SMALL_STEPS, return_state=True, jtilde=jt)


def small_cpu_run(arch, algo):
    """The CPU side of phase 13 (c), in a worker process of its own (two
    intra-op threads): the losses and every state leaf, as numpy."""
    import torch
    from torch.utils import _pytree as pytree

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(2)
    res, state = small_run(torch, arch, algo, "cpu", "per_step")
    return (res.upper_loss + res.lower_loss,
            [a.numpy() for a in pytree.tree_leaves(state)])


def check_trainer_small(torch):
    """Phase 13 (c): each family's reduced config (f32), MDBO and VRDBO,
    fused on the card (one capture each) against per_step on the CPU, on
    the same batches (drawn on the CPU) and J̃; the CPU runs go on in three
    worker processes while the card's run here. Then a reduced CLI run
    with ``--ckpt-dir`` whose checkpoints ``restore`` gives back bit for
    bit."""
    import multiprocessing
    import tempfile

    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.configs import get
    from repro_torch.core.common import replicate
    from repro_torch.core.hypergrad import tree_map
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params
    from repro_torch.train import x_dim
    from torch.utils import _pytree as pytree

    runs = [(arch, algo) for arch in TR_FAMILIES for algo in ("mdbo", "vrdbo")]
    worst = {}
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu = {run: pool.submit(small_cpu_run, *run) for run in runs}
        card = {run: small_run(torch, *run, "cuda", "fused") for run in runs}
        for run in runs:
            rg, sg = card[run]
            cpu_losses, cpu_state = cpu[run].result()
            loss = max(abs(a - b) for a, b in zip(
                rg.upper_loss + rg.lower_loss, cpu_losses))
            state = max(float(np.abs(u.cpu().numpy() - v).max())
                        for u, v in zip(pytree.tree_leaves(sg), cpu_state))
            finite = all(np.isfinite(rg.upper_loss + rg.lower_loss))
            worst["/".join(run)] = (loss, state)
            if not (finite and loss <= TOL_TR and state <= TOL_TR):
                raise AssertionError(
                    f"[13c] {'/'.join(run)}: the card departs from the "
                    f"CPU: losses {loss:.3g}, state {state:.3g} (limit "
                    f"{TOL_TR})")
    K, steps = TR_SMALL_K, TR_SMALL_STEPS
    print("[13c] card vs CPU, reduced, " + f"{steps} steps, K {K}, "
          f"{TR_BATCH} x {TR_SMALL_SEQ} tokens a node (limit "
          f"{TOL_TR}), max |loss diff|, max |state leaf diff|: " + json.dumps(
              {k: [float(f"{a:.3g}"), float(f"{b:.3g}")]
               for k, (a, b) in worst.items()}))
    # the CLI's checkpoints, restored
    cfg = get(TR_ARCH).reduced()
    kept = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_cli.main(["--arch", TR_ARCH, "--reduced", "--steps", "4",
                        "--eval-every", "2", "--ckpt-dir", tmp],
                       on_eval=lambda t, s: kept.setdefault(t, tree_map(
                           lambda a: a.cpu(), {"x": s.x, "y": s.y})))
        template = {"x": torch.zeros(TR_K, x_dim(cfg), device="cuda"),
                    "y": replicate(init_params(
                        cfg, torch.Generator().manual_seed(SEED),
                        device="cuda"), TR_K)}
        if latest_step(tmp) != 4 or not all(
                leaves_equal(torch, tree_map(lambda a: a.cpu(),
                                             restore(tmp, t, template)),
                             kept[t]) for t in (2, 4)):
            raise AssertionError("[13c] restore did not give back the "
                                 "checkpointed state")
    print("[13c] the reduced CLI run's checkpoints at steps 2 and 4 restore "
          "bit for bit")


def check_trainer(torch, card):
    """Phase 13: the decentralized bilevel LM trainer (``repro_torch.train``)
    on full-width ``smollm-360m``, which runs no TPU kernel and so adds
    none.

    (b) the CLI's run as per_step dispatch, 5 steps, through
    ``make_trainer_engine``, the card's busy share over those 5 steps (and
    the eval that ends them) under the profiler; (a) the CLI's own run,
    ``repro_torch.launch.train.main``, fused: one capture, two replays,
    every eval's losses finite; (b) its state after 5 steps against the
    per_step one, every leaf bit for bit, and the evals at steps 0 and 5
    equal; (d) the busy share over one replayed 5-step chunk; (c)
    :func:`check_trainer_small`."""
    from repro_torch.configs import get
    from repro_torch.core.hypergrad import tree_map
    from repro_torch.launch import train as train_cli
    from repro_torch.train import TrainerConfig, make_trainer_engine
    from torch.utils import _pytree as pytree

    dev = torch.device("cuda")
    cfg = get(TR_ARCH).config
    tc = TrainerConfig(mix="ring")     # the CLI's algorithm, J and steps
    to_cpu = partial(tree_map, lambda a: a.cpu())
    gb = 1e-9
    summary = {"card": card}

    # (b) per_step, and its busy share over steps 1-5
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, peng = make_trainer_engine(cfg, tc, TR_K, dispatch="per_step",
                                  device=dev)
    window = BusyWindow(torch)
    kept = {}

    def per_step_eval(t, state):
        if t == 0:
            window.start()
        else:
            kept["busy"] = window.stop()
            kept["state"] = to_cpu(state)

    pres = peng.run(*trainer_inputs(torch, cfg, tc, dev), steps=TR_EVAL,
                    seed=SEED, eval_every=TR_EVAL, on_eval=per_step_eval)
    busy, wall, n = kept["busy"]
    summary["per_step"] = {
        "steps_per_s": round(TR_EVAL / (wall / 1e3), 3),
        "busy_share": round(busy / wall, 4), "busy_ms": round(busy, 1),
        "wall_ms": round(wall, 1), "device_records_per_step": n // TR_EVAL,
        "peak_gb": round(torch.cuda.max_memory_allocated() * gb, 2)}
    print(f"[13b] per_step: {TR_EVAL} steps in {wall:.0f} ms under the "
          f"profiler, card busy {busy:.0f} ms ({busy / wall:.1%}), "
          f"{n // TR_EVAL} device records a step; "
          f"{time.perf_counter() - t_part:.1f} s", flush=True)
    del peng
    torch.cuda.empty_cache()
    t_part = time.perf_counter()

    # (a) the CLI, fused
    torch.cuda.reset_peak_memory_stats()
    hook = {"s": 0.0}

    def fused_eval(t, state):
        if t == 0:
            summary["params_per_node"] = sum(
                a.numel() for a in pytree.tree_leaves(state.y)) // TR_K
        elif t == TR_EVAL:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kept["fused"] = to_cpu(state)
            hook["s"] += time.perf_counter() - t0
        elif t == TR_STEPS:
            kept["live"] = state

    res, eng = train_cli.main(TR_ARGV, on_eval=fused_eval)
    torch.cuda.synchronize()
    curves = res.upper_loss + res.lower_loss
    if not (all(np.isfinite(curves)) and res.steps == [0, TR_EVAL, TR_STEPS]
            and (eng.captures, eng.replays) == (1, 2)):
        raise AssertionError(f"[13a] {res.steps}, losses {curves}, "
                             f"{eng.captures} captures, {eng.replays} replays")
    wall = res.wall_time_s - hook["s"]
    summary["fused_cli"] = {
        "steps_per_s": round(TR_STEPS / wall, 3),
        "tokens_per_s": round(TR_K * TR_BATCH * TR_SEQ * TR_STEPS / wall, 1),
        "wall_s": round(wall, 2), "capture_s": round(eng.capture_s, 2),
        "peak_gb": round(torch.cuda.max_memory_allocated() * gb, 2),
        "val_loss": [round(v, 4) for v in res.upper_loss]}
    # (b) fused == per_step
    if not (leaves_equal(torch, kept["fused"], kept["state"])
            and same_curves(pres, res, upto=2)):
        raise AssertionError("[13b] fused differs from per_step at full "
                             "width")
    print(f"[13b] fused == per_step bit for bit after {TR_EVAL} steps "
          f"(every state leaf) and at the evals of steps 0 and {TR_EVAL}; "
          f"the CLI's run {time.perf_counter() - t_part:.1f} s", flush=True)
    # (d) one replayed chunk
    draws = trainer_draws(torch, cfg, tc, dev, TR_EVAL)
    busy, wall, n = busy_share(torch, lambda: eng.run_chunk(kept["live"],
                                                            draws))
    summary["fused_replay"] = {
        "steps_per_s": round(TR_EVAL / (wall / 1e3), 3),
        "busy_share": round(busy / wall, 4), "busy_ms": round(busy, 1),
        "wall_ms": round(wall, 1), "device_records_per_step": n // TR_EVAL}
    print("[13] " + json.dumps(summary), flush=True)
    del eng, kept
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    check_trainer_small(torch)
    print(f"[13c] took {time.perf_counter() - t_part:.1f} s")
    return summary


def gossip_backends(drop):
    """(c)'s backend per mix of the registry: EF21 top-k, EF21 random mask
    (the contractive form), and async gossip at (b)'s 4 ms drop model."""
    return {"compressed_topk": {"ratio": 0.25, "error_feedback": True},
            "compressed_rand": {"ratio": 0.25, "error_feedback": True},
            "async_gossip": {"tau": AS_TAU, "drop_prob": drop}}


def check_compression_grid(torch):
    """Phase 14 (a): fig_compression.py's grid on the card."""
    from repro_torch.core.compression import comm_bytes_per_mix
    from repro_torch.data import make_device_sampler

    dev = torch.device("cuda")
    rows = []
    for ratio in (1.0,) + GS_RATIOS:
        for ef in ((False,) if ratio >= 1.0 else (False, True)):
            mix, mk = (("dense", None) if ratio >= 1.0 else
                       ("compressed_topk", {"ratio": ratio,
                                            "error_feedback": ef}))
            eng, sampler, ev = bilevel_engine(torch, "mdbo", BL_K, dev,
                                              "fused", mix, mk)
            smp = sampler()
            dsamp = make_device_sampler(smp.tr, smp.va, batch=smp.batch,
                                        J=BL_J, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, state = eng.run(dsamp, ev, steps=GS_STEPS,
                                 eval_every=GS_EVAL, return_state=True)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            tag = f"[14a] topk {ratio}{' ef' if ef else ''}"
            check_finite_falls(torch, tag, res, state)
            if (eng.captures, eng.replays) != (1, GS_STEPS // GS_EVAL):
                raise AssertionError(f"{tag}: {eng.captures} captures, "
                                     f"{eng.replays} replays")
            nbytes = comm_bytes_per_mix(state.y, ratio,
                                        W=bilevel_build(BL_K)[3].weights)
            rows.append({"ratio": ratio, "error_feedback": ef,
                         "final_loss": res.upper_loss[-1],
                         "consensus_x": res.consensus_x[-1],
                         "y_bytes_per_round": nbytes,
                         "run_s": round(sec, 2)})
    print(f"[14a] fig_compression, mdbo K={BL_K}, {GS_STEPS} steps fused: "
          + json.dumps(rows))
    if not rows[0]["y_bytes_per_round"] > rows[1]["y_bytes_per_round"] > (
            rows[3]["y_bytes_per_round"]):
        raise AssertionError("[14a] bytes per round do not fall with the "
                             "keep ratio")


def check_async_bench(torch, card):
    """Phase 14 (b): async_bench.py on the card, with a live Recorder on
    the async runs: the realized staleness histogram beside the stationary
    chain's mean, simulated time to the worst final loss, steps/s."""
    from repro_torch.core.async_gossip import expected_staleness
    from repro_torch.core.topology import EdgeDelayModel, ring_edge_drop_probs
    from repro_torch.data import make_device_sampler
    from repro_torch.obs import Recorder

    dev = torch.device("cuda")
    model = EdgeDelayModel(**AS_DELAY)
    n_edges = 2 * BL_K
    drop = ring_edge_drop_probs(model, BL_K, AS_DEADLINE_S)
    adapt_s = model.adaptive_deadline(AS_Q, n_edges=n_edges,
                                      rng=np.random.default_rng(SEED + 1))
    drop_adapt = ring_edge_drop_probs(model, BL_K, adapt_s)
    runs, recs, compute_s = {}, {}, None
    for name, mix, mk in (("sync", "ring_rolled", None),
                          ("async", "async_gossip",
                           {"tau": AS_TAU, "drop_prob": drop}),
                          ("async_adaptive", "async_gossip",
                           {"tau": AS_TAU, "drop_prob": drop_adapt})):
        rec = Recorder() if mix == "async_gossip" else None
        eng, sampler, ev = bilevel_engine(torch, "mdbo", BL_K, dev, "fused",
                                          mix, mk, rec)
        smp = sampler()
        dsamp = make_device_sampler(smp.tr, smp.va, batch=smp.batch, J=BL_J,
                                    device=dev)
        eng.run(dsamp, ev, steps=AS_STEPS, eval_every=AS_EVAL)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(dsamp, ev, steps=AS_STEPS, eval_every=AS_EVAL)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / AS_STEPS
        if eng.captures != 1 or not res.upper_loss[-1] < res.upper_loss[0]:
            raise AssertionError(f"[14b] {name}: {eng.captures} captures, "
                                 f"losses {res.upper_loss}")
        runs[name], recs[name] = res, rec
        compute_s = per_step if compute_s is None else min(compute_s,
                                                           per_step)
        print(f"[14b] {name}: {1 / per_step:.1f} steps/s on {card}, upper "
              f"loss {res.upper_loss[0]:.4f} -> {res.upper_loss[-1]:.4f}, "
              f"consensus x {res.consensus_x[-1]:.3g}")
    rng = np.random.default_rng(SEED)
    step_s = {"sync": compute_s + model.sync_round_s(rng, n_edges, AS_STEPS),
              "async": np.full(AS_STEPS, compute_s + AS_DEADLINE_S),
              "async_adaptive": np.full(AS_STEPS, compute_s + adapt_s)}
    cum = {k: np.concatenate([[0.0], np.cumsum(v)]) for k, v in step_s.items()}
    target = max(r.upper_loss[-1] for r in runs.values())
    to_target = {k: next((float(cum[k][s]) for s, loss in zip(
        r.steps, r.upper_loss) if loss <= target), float("inf"))
        for k, r in runs.items()}
    summary = {"compute_s_per_step": compute_s, "target_loss": target,
               "sim_time_to_target_s": to_target,
               "adaptive_deadline_s": adapt_s}
    for name, p in (("async", drop), ("async_adaptive", drop_adapt)):
        counts = np.asarray(recs[name].snapshot()["hist_counts"][
            "train_staleness"])
        # both runs (capture and timed) realize the same ages: 4 sites x
        # 2 in-edges x K nodes a step
        if counts.sum() != 2 * AS_STEPS * 4 * 2 * BL_K:
            raise AssertionError(f"[14b] {name}: {counts.sum()} ages counted")
        summary[name] = {
            "staleness_counts": counts.tolist(),
            "realized_mean": float((counts * np.arange(counts.size)).sum()
                                   / counts.sum()),
            "expected_mean": expected_staleness(AS_TAU, float(p.mean())),
            "drop_prob_mean": float(p.mean())}
    print("[14b] async_bench: " + json.dumps(summary))


def check_gossip_dispatch(torch, drop):
    """Phase 14 (c) and (d): per_step against fused, bit for bit with every
    mix slot, for MDBO and VRDBO on each new backend, and async tau 0
    against ring_rolled; then MDBO's card runs against the port's CPU run
    on the same batches, J̃ and deliveries."""
    from torch.utils import _pytree as pytree

    dev = torch.device("cuda")
    jt = np.random.default_rng(SEED).integers(0, BL_J,
                                              (GS_CHECK_STEPS + 1, BL_K))

    def run(algo, mix, mk, device, dispatch):
        eng, sampler, ev = bilevel_engine(torch, algo, BL_K, device,
                                          dispatch, mix, mk)
        res, state = eng.run(sampler(), ev, steps=GS_CHECK_STEPS,
                             eval_every=GS_CHECK_EVAL, return_state=True,
                             jtilde=jt)
        return res, (state, eng.mix_states), eng

    worst = {}
    for mix, mk in gossip_backends(drop).items():
        for algo in ("mdbo", "vrdbo"):
            rp, sp, _ = run(algo, mix, mk, dev, "per_step")
            rf, sf, eng = run(algo, mix, mk, dev, "fused")
            if not (leaves_equal(torch, sp, sf) and same_curves(rp, rf)
                    and (eng.captures, eng.replays) == (1, 2)
                    and len(sf[1]) == 4):
                raise AssertionError(f"[14c] {algo}/{mix}: fused differs "
                                     "from per_step")
            if algo == "mdbo":
                rc, sc, _ = run(algo, mix, mk, "cpu", "per_step")
                loss = max(abs(a - b) for a, b in zip(
                    rp.upper_loss + rp.lower_loss,
                    rc.upper_loss + rc.lower_loss))
                state = max(float((u.cpu().float() - v.float()).abs().max())
                            for u, v in zip(pytree.tree_leaves(sp),
                                            pytree.tree_leaves(sc)))
                worst[mix] = (loss, state)
                if not (loss <= TOL_BL_LOSS and state <= TOL_BL_PARAM):
                    raise AssertionError(f"[14d] {mix}: the card departs "
                                         f"from the CPU: {loss}, {state}")
    print(f"[14c] per_step == fused bit for bit (state and every mix slot) "
          f"for mdbo and vrdbo on {', '.join(gossip_backends(drop))} over "
          f"{GS_CHECK_STEPS} steps (two replays)")
    for algo in ("mdbo", "vrdbo"):
        ra, sa, _ = run(algo, "async_gossip",
                        {"tau": 0, "drop_prob": 0.7}, dev, "fused")
        rr, sr, _ = run(algo, "ring_rolled", None, dev, "fused")
        if not (leaves_equal(torch, sa[0], sr[0]) and same_curves(ra, rr)):
            raise AssertionError(f"[14c] {algo}: async tau 0 differs from "
                                 "ring_rolled")
    print("[14c] async_gossip tau 0 == ring_rolled bit for bit (mdbo, vrdbo)")
    print(f"[14d] mdbo card vs CPU over {GS_CHECK_STEPS} steps, max |loss "
          f"diff|, max |state or mix slot diff| (limits {TOL_BL_LOSS}, "
          f"{TOL_BL_PARAM}): " + json.dumps(
              {k: [float(f"{a:.3g}"), float(f"{b:.3g}")]
               for k, (a, b) in worst.items()}))


def check_gossip_trainer(torch, trainer):
    """Phase 14 (e): the reduced LM trainer on EF21 top-k and on async
    gossip through ``make_trainer_engine``, fused against per_step with
    every mix slot, and the peak memory; then the full-width arithmetic
    from phase 13's own numbers."""
    from repro_torch.configs import get
    from repro_torch.train import TrainerConfig, make_trainer_engine

    dev = torch.device("cuda")
    cfg = get(TR_ARCH).reduced()
    tc = TrainerConfig(mix="ring")
    peaks = {}
    for mix, mk in (("compressed_topk", {"ratio": 0.25,
                                         "error_feedback": True}),
                    ("async_gossip", {"tau": 2, "drop_prob": 0.3})):
        out = {}
        for dispatch in ("per_step", "fused"):
            torch.cuda.reset_peak_memory_stats()
            _, eng = make_trainer_engine(cfg, tc, GS_TR_K, dispatch=dispatch,
                                         mix=mix, mix_kwargs=mk, device=dev)
            res, state = eng.run(*trainer_inputs(torch, cfg, tc, dev,
                                                 GS_TR_K),
                                 steps=GS_TR_STEPS, seed=SEED,
                                 eval_every=GS_TR_EVAL, return_state=True)
            out[dispatch] = (res, (state, eng.mix_states))
            peaks[f"{mix}/{dispatch}"] = round(
                torch.cuda.max_memory_allocated() / 1e9, 3)
        (rp, sp), (rf, sf) = out["per_step"], out["fused"]
        if not (leaves_equal(torch, sp, sf) and same_curves(rp, rf)
                and all(np.isfinite(rf.upper_loss))):
            raise AssertionError(f"[14e] {mix}: fused differs from per_step")
    print(f"[14e] reduced {TR_ARCH}, K {GS_TR_K}, {GS_TR_STEPS} steps: fused "
          "== per_step bit for bit (state and every mix slot) on EF21 top-k "
          "and async gossip; peak GB " + json.dumps(peaks))
    y_gb = trainer["params_per_node"] * 4 * TR_K / 1e9
    peak = trainer["fused_cli"]["peak_gb"]
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"[14e] full width, not run: a y-shaped tree is "
          f"{trainer['params_per_node']:,} x 4 B x {TR_K} nodes = "
          f"{y_gb:.2f} GB; MDBO mixes two (zg, y) a step. Phase 13's peak "
          f"{peak} GB plus EF21's accumulator per site, {2 * y_gb:.1f} GB: "
          f"at least {peak + 2 * y_gb:.1f} GB, before the EF mix's own "
          f"y-sized temporaries (the innovation, its compression, (W - I) "
          f"h); plus async gossip's two caches per site, {4 * y_gb:.1f} GB: "
          f"at least {peak + 4 * y_gb:.1f} GB; the card holds "
          f"{card_gb:.1f} GB")


def check_gossip(torch, card, trainer):
    """Phase 14: compressed and asynchronous gossip (``core/compression.py``,
    ``core/async_gossip.py``, the Engine's stateful-mix carry and
    ``repro_torch.obs``), which runs no TPU kernel and so adds none."""
    from repro_torch.core.topology import EdgeDelayModel, ring_edge_drop_probs

    for part, fn in (("a", lambda: check_compression_grid(torch)),
                     ("b", lambda: check_async_bench(torch, card)),
                     ("c, d", lambda: check_gossip_dispatch(
                         torch, ring_edge_drop_probs(
                             EdgeDelayModel(**AS_DELAY), BL_K,
                             AS_DEADLINE_S))),
                     ("e", lambda: check_gossip_trainer(torch, trainer))):
        t0 = time.perf_counter()
        fn()
        print(f"[14{part}] took {time.perf_counter() - t0:.1f} s",
              flush=True)


# ---------------------------------------------------------------------------
# Phase 15: the dense configs of the eighth slice and the rest of the engine
# ---------------------------------------------------------------------------

def paged_row(torch, label, cfg, lengths, Q=None, tag="[15]",
              capacity=QW_CAPACITY):
    """The paged decode kernel (or, with ``Q``, the verify window) at a
    config's serving shape against its plain version, bf16, timed beside
    it, L2 cold: a pool of two slots' ``capacity`` (or as many blocks as the
    lengths need), slot 1 sharing slot 0's first 7 pages. Returns the row's
    kernels-line entry."""
    from repro_torch.kernels import (paged_attention, paged_attention_multi,
                                     paged_attention_multi_ref,
                                     paged_attention_ref)

    kernel, plain = ((paged_attention_multi, paged_attention_multi_ref) if Q
                     else (paged_attention, paged_attention_ref))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    n_pages, layer = capacity // BLOCK_SIZE, cfg.n_layers - 1
    # two slots' capacity, or the blocks the lengths need if more
    blocks = max(2 * n_pages, sum(-(-n // BLOCK_SIZE) for n in lengths))
    case = paged_case(torch, gen, lengths=lengths, H=cfg.n_heads,
                      Hkv=cfg.n_kv_heads, Dh=cfg.head_dim, L=cfg.n_layers,
                      bs=BLOCK_SIZE, n_pages=n_pages, num_blocks=blocks,
                      dtype=cfg.dtype, alias_pages=7, Q=Q)
    out, ref = kernel(*case, layer), plain(*case, layer)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    excess = within_limit(out, ref)
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{kernel.__name__} {label}: |kernel - plain| "
                             f"exceeds its limit by {excess}")
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    ms = cuda_ms(torch, lambda: kernel(*case, layer), flush=flush)
    plain_ms = cuda_ms(torch, lambda: plain(*case, layer), flush=flush)
    bound, bound_by = bound_ms(case[0], case[1], case[3], case[4])
    del flush
    print(f"{tag} {kernel.__name__} {label}: B={len(lengths)} Q={Q or 1} "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} Dh={cfg.head_dim} "
          f"L={cfg.n_layers} n_pages={n_pages}: max_abs_err {err:.3e} (tol "
          f"{BF16_ATOL} + {BF16_RTOL} |plain|); {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}), L2 cold")
    return {"name": kernel.__name__, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:"
                        + ("145" if Q else "213"),
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None}


def check_new_shapes(torch, configs):
    """Phase 15 (rows): the paged kernels at the shapes the new configs
    hand them, each against its plain version and timed: decode at
    qwen2.5-3b's heads (16 over 2 of 128) and granite-8b's (32 over 8), and
    qwen's verify window at k 3 (32 rows). Returns ``{label: entry}``."""
    qw, gr = configs[QW_ARCH], configs[GR_ARCH]
    lengths = [258, 300, 17, 316]
    return {
        "decode qwen": paged_row(torch, "qwen2.5-3b", qw, lengths),
        "decode granite": paged_row(torch, "granite-8b", gr, lengths),
        "verify qwen": paged_row(torch, "qwen2.5-3b k 3", qw,
                                 [258, 300, 20, 316], Q=SPEC_K + 1),
    }


def dense_flash_cases():
    """Phase 15's flash-attention cases, as :func:`check_flash_kernel`
    takes them: the cohort drain's batch-4 prefill and the sliding-window
    prefill at qwen2.5-3b's heads, minicpm-2b's bucketed prefill (36 heads
    of 64) and granite-8b's paged prefill (32 heads over 8 of 128)."""
    from repro_torch.configs import get

    qw, mc, gr = (get(a).config for a in (QW_ARCH, MC_ARCH, GR_ARCH))
    window = get(QW_ARCH).model_for_shape(SWA_SHAPE).window
    return [
        ("qwen2.5-3b cohort prefill", 4, qw.n_heads, qw.n_kv_heads, 300,
         qw.head_dim, "bfloat16", True, None),
        ("qwen2.5-3b long_500k prefill", 1, qw.n_heads, qw.n_kv_heads,
         SWA_PROMPT, qw.head_dim, "bfloat16", True, window),
        ("minicpm-2b bucketed prefill", 1, mc.n_heads, mc.n_kv_heads, 512,
         mc.head_dim, "bfloat16", True, None),
        ("granite-8b prefill", 1, gr.n_heads, gr.n_kv_heads, 300,
         gr.head_dim, "bfloat16", True, None),
    ]


def seeded_biases(torch, params, scale, seed):
    """Fill every QKV bias leaf with ``scale`` x a normal draw from a
    generator seeded ``seed`` on the leaves' device, in place."""
    attn = params["layers"]["attn"]
    gen = torch.Generator(device=attn["wq"]["b"].device).manual_seed(seed)
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        b.copy_(scale * torch.randn(b.shape, generator=gen, device=b.device))


def dense_want(cfg, st, kernel=True, rounds=0):
    """Launches a dense drain must count: :func:`paged_want` on the paged
    kernel path; elsewhere (the reference read path, cohort and continuous
    modes) the flash kernel per layer per target prefill only."""
    if kernel:
        return paged_want(cfg, st, rounds)
    return {"flash_attention": cfg.n_layers * st["prefills"]}


def serve_dense(torch, what, cfg, params, device, prompts, max_new, want_fn,
                widths=None, **kw):
    """Drain ``prompts`` through ``ServeEngine(cfg, params, **kw)``: full
    streams in the vocabulary, and every kernel wrapper's count equal to
    ``want_fn(stats)``. A list ``widths`` gets the table width of each
    paged decode chunk. Returns (engine, streams, metrics)."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device=device, **kw)
    if widths is not None:
        chunk = eng._paged_decode

        def recorded(params, tok, pool, tables, *rest):
            widths.append(tables.shape[1])
            return chunk(params, tok, pool, tables, *rest)

        eng._paged_decode = recorded
    streams, m = drain(torch, eng, prompts, max_new)
    if any(len(s) != max_new for s in streams):
        raise AssertionError(f"{what}: stream lengths "
                             f"{[len(s) for s in streams]}")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        raise AssertionError(f"{what}: token out of the vocabulary")
    check_counts(what, m["counts"], want_fn(m))
    return eng, streams, m


def replay_cohort(torch, cfg, params, prompts, streams, attend, device, *,
                  max_batch, capacity, max_new, extras=None):
    """Teacher-forced per-step logits [n, max_new, V] (f32) of the cohort
    drain: each cohort's left-padded batch prefill through ``attend`` (with
    the family's ``extras`` as in :func:`replay`), then its served tokens
    fed back through ``decode_step``."""
    from repro_torch.models import decode_step, prefill

    out = []
    for c in range(0, len(prompts), max_batch):
        group, served = prompts[c:c + max_batch], streams[c:c + max_batch]
        S = max(map(len, group))
        toks = np.zeros((len(group), S), np.int32)
        for i, p in enumerate(group):
            toks[i, S - len(p):] = p
        toks = torch.as_tensor(toks, device=device)
        kw = extras(toks) if extras else {"tokens": toks}
        lg, cache = prefill(cfg, params, kw.pop("tokens"), capacity,
                            attend=attend, **kw)
        steps = [lg[:, -1].float()]
        for t in range(max_new - 1):
            tok = torch.as_tensor([[s[t]] for s in served], dtype=torch.int32,
                                  device=device)
            lg, cache = decode_step(cfg, params, tok, cache)
            steps.append(lg[:, -1].float())
        out.append(torch.stack(steps, dim=1))
    return torch.cat(out)


def served_gap(torch, plain, streams, device) -> float:
    """How far below the plain replay's argmax logit the served tokens'
    logits fall, at worst."""
    served = torch.as_tensor(streams, device=device).long()
    served_logit = plain.gather(-1, served[..., None])[..., 0]
    return float((plain.max(-1).values - served_logit).max())


def check_agreement(torch, tag, ker, plain, streams, device):
    """The kernel replay's logits within ``TOL_REPLAY`` of the plain
    replay's, and every served token within it of the plain argmax."""
    diff = float((ker - plain).abs().max())
    gap = served_gap(torch, plain, streams, device)
    print(f"{tag} replay over {len(streams)} x {len(streams[0])} steps: max "
          f"|logits kernels - plain| {diff:.4f} (tol {TOL_REPLAY}); served "
          f"token within {gap:.4f} of the plain argmax logit (tol "
          f"{TOL_REPLAY}); |logit| max {float(plain.abs().max()):.3f}")
    if not torch.isfinite(ker).all() or diff > TOL_REPLAY \
            or gap > TOL_REPLAY:
        raise AssertionError(f"{tag} replay: the served streams disagree "
                             "with the plain versions beyond the bf16 "
                             "tolerance")


def check_same_or_near_tie(torch, tag, cfg, params, prompts, streams, base,
                           device, *, capacity, max_new, extras=None,
                           replay_fn=None):
    """``streams`` must equal ``base`` wherever the teacher-forced logits
    tell them apart: where a stream differs, both it and its base are
    replayed through the plain attention (by :func:`replay`, or
    ``replay_fn(prompts, streams)``), and every served token must lie
    within ``TOL_REPLAY`` of the plain argmax logit (a bf16 near-tie)."""
    from repro_torch.kernels import paged_attention_ref

    differ = [i for i in range(len(streams)) if streams[i] != base[i]]
    if not differ:
        print(f"{tag} every stream equals the kernel drain's")
        return 0
    sel = [prompts[i] for i in differ]
    if replay_fn is None:
        def replay_fn(ps, ss):
            return replay(torch, cfg, params, ps, ss, paged_attention_ref,
                          device, capacity=capacity, max_new=max_new,
                          extras=extras)
    gaps = [served_gap(torch, replay_fn(sel, [s[i] for i in differ]),
                       [s[i] for i in differ], device)
            for s in (streams, base)]
    print(f"{tag} {len(differ)} of {len(streams)} streams differ from the "
          f"kernel drain's; under the plain replay each served token is "
          f"within {max(gaps):.4f} of the argmax logit (tol {TOL_REPLAY})")
    if max(gaps) > TOL_REPLAY:
        raise AssertionError(f"{tag}: streams differ beyond a bf16 near-tie")
    return len(differ)


def check_qwen(torch, card, cfg, params, device, rows):
    """Phase 15 (a): full-width qwen2.5-3b through every serving mode of
    the engine: the cohort drain, the paged drain on the kernel and the
    reference read paths and with pow2 prefill buckets, speculative
    decoding at rounds 1 and the default, a live Recorder, and the serving
    CLI's ``--metrics``."""
    import tempfile

    from repro_torch.kernels import (attention_ref, ops, paged_attention,
                                     paged_attention_ref)
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.obs import Recorder
    from repro_torch.serve import SpecConfig
    from repro_torch.weights import truncate_params

    prompts = workload(cfg.vocab, n=QW_REQUESTS)
    shape = {"capacity": QW_CAPACITY, "max_new": QW_MAX_NEW}
    paged = dict(mode="paged", capacity=QW_CAPACITY, max_batch=QW_MAX_BATCH,
                 block_size=BLOCK_SIZE, num_blocks=QW_NUM_BLOCKS,
                 decode_chunk=DECODE_CHUNK)
    keys = ("wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
            "prefills", "decode_steps", "decode_dispatches", "preemptions",
            "counts")

    # cohort: two left-padded cohorts of 4, one batch-4 flash launch per
    # layer per cohort prefill
    eng, cohort, m = serve_dense(
        torch, "[15a] cohort drain", cfg, params, device, prompts,
        QW_MAX_NEW, lambda st: dense_want(cfg, st, kernel=False),
        mode="cohort", capacity=QW_CAPACITY, max_batch=QW_MAX_BATCH)
    if m["prefills"] != 2:
        raise AssertionError(f"cohort drain: {m['prefills']} cohorts")
    rows["flash cohort"]["launches"] = m["flash_launches"]
    print("[15a] cohort " + json.dumps({k: m[k] for k in keys if k in m}))
    kw = {"max_batch": QW_MAX_BATCH, **shape}
    check_agreement(torch, "[15a] cohort", replay_cohort(
        torch, cfg, eng.params, prompts, cohort, ops.attention, device, **kw),
        replay_cohort(torch, cfg, eng.params, prompts, cohort, attention_ref,
                      device, **kw), cohort, device)
    del eng

    # paged, the kernel read path, with a live recorder
    rec = Recorder()
    eng, kernel, m = serve_dense(
        torch, "[15a] paged kernel drain", cfg, params, device, prompts,
        QW_MAX_NEW, lambda st: dense_want(cfg, st), kv_impl="kernel",
        recorder=rec, **paged)
    if m["preemptions"] < 1:
        raise AssertionError("paged drain: the pool did not force a "
                             "preemption")
    rows["decode qwen"]["launches"] = m["launches"]
    snap = rec.snapshot()
    obs = snap["observations"]
    if (snap["counters"].get("serve_finished") != QW_REQUESTS
            or obs["serve_ttft_s"]["count"] != QW_REQUESTS
            or obs["serve_latency_s"]["count"] != QW_REQUESTS):
        raise AssertionError(f"recorder: finished "
                             f"{snap['counters'].get('serve_finished')}, "
                             f"observations {obs}")
    print("[15a] paged kernel " + json.dumps({k: m[k] for k in keys}))
    print(f"[15a] recorder: serve_finished "
          f"{snap['counters']['serve_finished']:.0f}, TTFT p50 "
          f"{obs['serve_ttft_s']['p50'] * 1e3:.1f} ms, max "
          f"{obs['serve_ttft_s']['max'] * 1e3:.1f} ms, latency p50 "
          f"{obs['serve_latency_s']['p50'] * 1e3:.1f} ms, "
          f"serve_tokens_per_sec {snap['gauges']['serve_tokens_per_sec']:.1f}"
          f" (drain {m['tokens_per_s']:.1f} tokens/s); {card}")
    check_agreement(torch, "[15a] paged kernel", replay(
        torch, cfg, eng.params, prompts, kernel, paged_attention, device,
        **shape), replay(torch, cfg, eng.params, prompts, kernel,
                         paged_attention_ref, device, **shape), kernel,
        device)
    del eng

    for what, extra in (("reference", {"kv_impl": "reference"}),
                        ("bucketed", {"kv_impl": "kernel",
                                      "prefill_bucket": True})):
        eng, streams, m = serve_dense(
            torch, f"[15a] paged {what} drain", cfg, params, device,
            prompts, QW_MAX_NEW, lambda st, k=what != "reference":
            dense_want(cfg, st, kernel=k), **extra, **paged)
        print(f"[15a] paged {what} " + json.dumps({k: m[k] for k in keys}))
        check_same_or_near_tie(torch, f"[15a] paged {what}", cfg, eng.params,
                               prompts, streams, kernel, device, **shape)
        del eng

    # speculative decoding on the damped target, its first 2 layers the
    # draft, beside a plain paged drain of the same target
    target = damped(torch, params, SPEC_DRAFT_LAYERS, SPEC_DAMP)
    eng, base, bm = serve_dense(
        torch, "[15a] damped paged drain", cfg, target, device, prompts,
        QW_MAX_NEW, lambda st: dense_want(cfg, st), **paged)
    print("[15a] damped target, plain " + json.dumps({k: bm[k] for k in keys}))
    del eng
    draft = (cfg.with_overrides(n_layers=SPEC_DRAFT_LAYERS),
             truncate_params(target, SPEC_DRAFT_LAYERS))
    for rounds in (1, None):
        spec = SpecConfig(*draft, k=SPEC_K, rounds=rounds)
        n_rounds = spec.rounds_for(DECODE_CHUNK)
        eng, streams, m = serve_dense(
            torch, f"[15a] speculative drain, rounds {n_rounds}", cfg,
            target, device, prompts, QW_MAX_NEW, lambda st, r=n_rounds:
            dense_want(cfg, st, rounds=st["decode_dispatches"] * r),
            speculate=spec, **paged)
        if rounds is None:
            rows["verify qwen"]["launches"] = m["multi_launches"]
        print(f"[15a] speculative, rounds {n_rounds} " + json.dumps(
            {k: m[k] for k in keys + ("spec_proposed", "spec_accepted",
                                      "multi_launches")}))
        check_spec_replay(torch, cfg, eng.params, prompts, streams, base,
                          device, tag=f"[15a] rounds {n_rounds}", **shape)
        del eng
    del target, draft

    # the serving CLI, cohort mode with --metrics (reduced widths: the CLI
    # draws its weights on the host)
    with tempfile.TemporaryDirectory() as tmp:
        serve_main(["--arch", QW_ARCH, "--reduced", "--mode", "cohort",
                    "--metrics", tmp, "--requests", "4",
                    "--device", device.type])
        files = sorted(os.listdir(tmp))
    if files != ["metrics.jsonl", "metrics.prom"]:
        raise AssertionError(f"serving CLI --metrics wrote {files}")
    print(f"[15a] serving CLI --mode cohort --metrics wrote {files}")


def check_swa(torch, cfg, params, device, rows):
    """Phase 15 (d): qwen2.5-3b's long_500k variant (window 4 096) in
    continuous mode at a capacity of one window: a prompt past the window,
    the flash kernel with the window at Dh 128, the rolled ring wrapped by
    decode; the streams replayed teacher-forced with the plain attention."""
    from repro_torch.kernels import attention_ref, ops

    prompt = [np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab, size=SWA_PROMPT).astype(np.int32)]
    eng, streams, m = serve_dense(
        torch, "[15d] sliding-window drain", cfg, params, device, prompt,
        SWA_MAX_NEW, lambda st: dense_want(cfg, st, kernel=False),
        mode="continuous", capacity=SWA_CAPACITY, max_batch=1)
    rows["flash swa"]["launches"] = m["flash_launches"]
    print("[15d] " + json.dumps({k: m[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "counts")}))
    kw = {"capacity": SWA_CAPACITY, "max_new": SWA_MAX_NEW}
    check_agreement(torch, "[15d]", replay_hybrid(
        torch, cfg, eng.params, prompt, streams, ops.attention, ops.rglru,
        device, **kw), replay_hybrid(torch, cfg, eng.params, prompt,
                                     streams, attention_ref, ops.rglru,
                                     device, **kw), streams, device)


def check_granite(torch, cfg, params, device, rows):
    """Phase 15 (b): full-width granite-8b, a paged kernel drain of 4
    requests, replayed teacher-forced through the kernels (flash prefill,
    paged decode) and through both plain versions."""
    from repro_torch.kernels import (attention_ref, paged_attention,
                                     paged_attention_ref)

    prompts = workload(cfg.vocab, n=QW_REQUESTS)[:GR_REQUESTS]
    shape = {"capacity": QW_CAPACITY, "max_new": QW_MAX_NEW}
    eng, streams, m = serve_dense(
        torch, "[15b] granite paged drain", cfg, params, device, prompts,
        QW_MAX_NEW, lambda st: dense_want(cfg, st), mode="paged",
        capacity=QW_CAPACITY, max_batch=QW_MAX_BATCH, block_size=BLOCK_SIZE,
        decode_chunk=DECODE_CHUNK)
    rows["decode granite"]["launches"] = m["launches"]
    rows["flash granite"]["launches"] = m["flash_launches"]
    print("[15b] " + json.dumps({k: m[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "decode_steps", "counts")}))
    check_agreement(torch, "[15b]", replay(
        torch, cfg, eng.params, prompts, streams, paged_attention, device,
        **shape), replay(torch, cfg, eng.params, prompts, streams,
                         paged_attention_ref, device,
                         prefill_attend=attention_ref, **shape), streams,
        device)


def check_minicpm(torch, cfg, params, device, rows):
    """Phase 15 (c): full-width minicpm-2b (MHA, 36 heads of 64), a
    continuous drain with pow2 prefill buckets, replayed teacher-forced
    (at exact length) with the flash kernel and the plain attention."""
    from repro_torch.kernels import attention_ref, ops

    prompts = workload(cfg.vocab, n=QW_REQUESTS)
    eng, streams, m = serve_dense(
        torch, "[15c] minicpm continuous drain", cfg, params, device,
        prompts, QW_MAX_NEW, lambda st: dense_want(cfg, st, kernel=False),
        mode="continuous", capacity=QW_CAPACITY, max_batch=QW_MAX_BATCH,
        decode_chunk=DECODE_CHUNK, prefill_bucket=True)
    rows["flash minicpm"]["launches"] = m["flash_launches"]
    print("[15c] " + json.dumps({k: m[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "prefills", "decode_steps", "counts")}))
    kw = {"capacity": QW_CAPACITY, "max_new": QW_MAX_NEW}
    check_agreement(torch, "[15c]", replay_hybrid(
        torch, cfg, eng.params, prompts, streams, ops.attention, ops.rglru,
        device, **kw), replay_hybrid(torch, cfg, eng.params, prompts,
                                     streams, attention_ref, ops.rglru,
                                     device, **kw), streams, device)


def check_dense_configs(torch, card, device, flash_rows):
    """Phase 15: the paged kernels at the new configs' shapes, then each
    config served at its published width, one model on the card at a time.
    ``flash_rows``: :func:`check_flash_kernel`'s entries for
    :func:`dense_flash_cases`, in order. Prints the rows of the kernel
    table it measured, with their launches, as one JSON line."""
    from repro_torch.configs import get
    from repro_torch.models import init_params

    configs = {a: get(a).config for a in (QW_ARCH, GR_ARCH, MC_ARCH)}
    swa = get(QW_ARCH).model_for_shape(SWA_SHAPE)
    t0 = time.perf_counter()
    rows = check_new_shapes(torch, configs)
    rows.update(zip(("flash cohort", "flash swa", "flash minicpm",
                     "flash granite"), flash_rows, strict=True))
    print(f"[15 rows] took {time.perf_counter() - t0:.1f} s", flush=True)

    def load(arch):
        params = init_params(configs[arch], torch.Generator(
            device=device).manual_seed(SEED), device=device)
        if configs[arch].qkv_bias:
            seeded_biases(torch, params, QW_BIAS, SEED + 15)
        return params

    for part, arch, fn in (
            ("a", QW_ARCH, lambda p: check_qwen(
                torch, card, configs[QW_ARCH], p, device, rows)),
            ("d", QW_ARCH, lambda p: check_swa(torch, swa, p, device, rows)),
            ("b", GR_ARCH, lambda p: check_granite(
                torch, configs[GR_ARCH], p, device, rows)),
            ("c", MC_ARCH, lambda p: check_minicpm(
                torch, configs[MC_ARCH], p, device, rows))):
        t0 = time.perf_counter()
        if part != "d":   # (d) serves (a)'s weights
            params = None
            torch.cuda.empty_cache()
            params = load(arch)
        fn(params)
        print(f"[15{part}] took {time.perf_counter() - t0:.1f} s",
              flush=True)
    del params
    torch.cuda.empty_cache()
    print("[15 rows] " + json.dumps(rows) + f" {card}")


# ---------------------------------------------------------------------------
# Phase 16: the moe, vlm and audio families
# ---------------------------------------------------------------------------

def family_configs():
    """Phase 16's configs: the published widths, the depth cut only where
    one 80 GB card forces it (``FAM_DEPTH``)."""
    from repro_torch.configs import get

    return {arch: (get(arch).config if depth is None
                   else get(arch).config.with_overrides(n_layers=depth))
            for arch, depth in FAM_DEPTH.items()}


def family_flash_cases(cfgs):
    """Phase 16's flash-attention cases, as :func:`check_flash_kernel`
    takes them: whisper-tiny's encoder (1 500 frames, full) and its prefill
    cross-attention (a 300-token prompt over the 1 500 frames, full),
    phi3.5-moe's prefill (32 heads over 8 of 128) and chameleon-34b's (64
    over 8 of 128, a 1 300-token prompt)."""
    wh, phi, ch = cfgs[WH_ARCH], cfgs[PHI_ARCH], cfgs[CH_ARCH]
    return [
        ("whisper-tiny encoder", 1, wh.n_heads, wh.n_kv_heads, wh.src_len,
         wh.head_dim, "bfloat16", False, None),
        ("whisper-tiny cross-attention", 1, wh.n_heads, wh.n_kv_heads, 300,
         wh.head_dim, "bfloat16", False, None, wh.src_len),
        ("phi3.5-moe prefill", 1, phi.n_heads, phi.n_kv_heads, 300,
         phi.head_dim, "bfloat16", True, None),
        ("chameleon-34b prefill", 1, ch.n_heads, ch.n_kv_heads, 1300,
         ch.head_dim, "bfloat16", True, None),
    ]


def family_paged_rows(torch, cfgs):
    """Phase 16 (rows): the paged kernels at the new heads, each against
    its plain version and timed: decode at phi3.5-moe's (32 over 8 of 128)
    and chameleon-34b's (64 over 8 of 128, slots of 1 100-1 400
    positions), and chameleon's verify window at k 8 (Q 9 x G 8 = 72 rows,
    past one 64-row tile)."""
    phi, ch = cfgs[PHI_ARCH], cfgs[CH_ARCH]
    return {
        "decode phi": paged_row(torch, "phi3.5-moe", phi, [258, 300, 17, 316],
                                tag="[16]"),
        "decode chameleon": paged_row(torch, "chameleon-34b", ch,
                                      [1100, 1300, 1400, 1250], tag="[16]",
                                      capacity=CH_CAPACITY),
        "verify chameleon": paged_row(torch, "chameleon-34b k 8", ch,
                                      [1109, 1309, 20, 1259],
                                      Q=CH_SPEC_K + 1, tag="[16]",
                                      capacity=CH_CAPACITY),
    }


@contextlib.contextmanager
def counting_drops(torch):
    """Every per-token MoE routing's dropped (token, choice) assignments
    while the block runs: the groups of one token that a slot decode, a
    paged decode, a verify window row or a draft step routes. Yields a list
    of device counts (summed once, at the end)."""
    from repro_torch.models import moe

    route, drops = moe.route, []

    def watched(cfg, p, flat):
        r = route(cfg, p, flat)
        if flat.shape[1] == 1:
            drops.append((~r["keep"]).sum())
        return r

    moe.route = watched
    try:
        yield drops
    finally:
        moe.route = route


def serve_family(torch, card, what, cfg, params, device, prompts, max_new,
                 want_fn, **kw):
    """:func:`serve_dense` with the MoE family's per-token drops counted
    (there must be none: a group of one token has C = 4 >= K), each paged
    decode chunk's table width recorded (``widths``), and the drain's
    tokens/s and the card's peak memory printed. Returns (engine, streams,
    metrics)."""
    torch.cuda.reset_peak_memory_stats()
    widths = []
    paged = kw.get("mode") == "paged" and "speculate" not in kw
    with counting_drops(torch) as drops:
        eng, streams, m = serve_dense(torch, what, cfg, params, device,
                                      prompts, max_new, want_fn,
                                      widths=widths if paged else None, **kw)
    m["widths"] = widths
    m["per_token_routings"] = len(drops)
    m["dropped"] = int(torch.stack(drops).sum()) if drops else 0
    m["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if cfg.family == "moe" and (not drops or m["dropped"]):
        raise AssertionError(f"{what}: {m['dropped']} tokens dropped in "
                             f"{len(drops)} per-token MoE routings")
    print(f"{what}: " + json.dumps({k: m[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "prefills",
        "decode_steps", "counts", "per_token_routings", "dropped",
        "peak_gb") if k in m}) + f"; {card}")
    return eng, streams, m


def family_want(cfg, st, kernel=True, rounds=0):
    """Launches a phase-16 drain must count: :func:`dense_want`, and for
    the audio family the flash kernel per encoder layer at the slot
    cache's init (continuous mode) and per prefill, and twice per decoder
    layer per prefill (self- and cross-attention)."""
    if cfg.family != "audio":
        return dense_want(cfg, st, kernel, rounds)
    inits = 1 if st["mode"] == "continuous" else 0
    return {"flash_attention": cfg.n_enc_layers * (inits + st["prefills"])
            + 2 * cfg.n_layers * st["prefills"]}


def replay_slots(torch, cfg, params, prompts, streams, attend, device, *,
                 capacity, max_new, extras):
    """Teacher-forced per-step logits [n, max_new, V] (f32) of a
    continuous drain: each prompt's prefill (with the engine's family
    ``extras``) through ``attend`` into its slot, then the served tokens
    through the slot decode, each slot at its own position and routed
    alone (``moe_per_token``), as the engine's slot decode routes it."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batch import init_slot_cache, slot_axes, write_slot

    n = len(prompts)
    src = None
    if cfg.family == "audio":
        src = torch.zeros((n, cfg.src_len, cfg.d_model), dtype=cfg.dtype,
                          device=device)
    cache = init_slot_cache(cfg, n, capacity, device=device, params=params,
                            src_embeds=src)
    axes = slot_axes(cfg, capacity, params=params)
    first = []
    for i, p in enumerate(prompts):
        kw = extras(torch.as_tensor(p[None], device=device))
        at_site([("pre", i)])
        lg, c = prefill(cfg, params, kw.pop("tokens"), capacity,
                        attend=attend, **kw)
        write_slot(cache, c, i, axes)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)]
    for t in range(max_new - 1):
        tok = torch.as_tensor([[s[t]] for s in streams], dtype=torch.int32,
                              device=device)
        at_site([("dec", i, t) for i in range(n)])
        lg, cache = decode_step(cfg, params, tok, cache, moe_per_token=True)
        steps.append(lg[:, -1].float())
    return torch.stack(steps, dim=1)


def in_batches(torch, fn, prompts, streams, size=FAM_MAX_BATCH):
    """``fn(prompts, streams, g)`` over consecutive groups ``g`` of
    ``size`` requests, concatenated: a replay batched as the engine of
    ``size`` slots batched the drain (its slots take the requests in order,
    all with one budget), so each matmul has the engine's shape and rounds
    as it rounded."""
    out = []
    for i in range(0, len(prompts), size):
        SITE["offset"] = i
        try:
            out.append(fn(prompts[i:i + size], streams[i:i + size],
                          i // size))
        finally:
            SITE["offset"] = 0
    return torch.cat(out)


def check_slots(torch, tag, cfg, eng, prompts, streams, device, **shape):
    """A continuous drain's teacher-forced replay, the flash kernel against
    the plain attention (decode attends through the einsum ``sdpa`` on both
    paths). Returns the plain replay's logits."""
    from repro_torch.kernels import attention_ref, ops

    kw = {"extras": eng._prefill_inputs, **shape}
    ker, plain = replay_pair(
        torch, cfg, lambda: in_batches(torch, lambda ps, ss, _: replay_slots(
            torch, cfg, eng.params, ps, ss, ops.attention, device, **kw),
            prompts, streams),
        lambda: in_batches(torch, lambda ps, ss, _: replay_slots(
            torch, cfg, eng.params, ps, ss, attention_ref, device, **kw),
            prompts, streams), tag)
    check_agreement(torch, tag, ker, plain, streams, device)
    return plain


def check_paged(torch, tag, cfg, eng, prompts, streams, widths, device,
                **shape):
    """A paged kernel drain's teacher-forced replay: flash prefill and the
    decode kernel, against both plain versions. ``widths``: the table
    width of each of the drain's decode chunks, in order (two chunks per
    group of requests)."""
    from repro_torch.kernels import (attention_ref, paged_attention,
                                     paged_attention_ref)

    kw = {"extras": eng._prefill_inputs, **shape}
    per = -(-(shape["max_new"] - 1) // DECODE_CHUNK)   # chunks per group
    if len(widths) != per * -(-len(prompts) // FAM_MAX_BATCH):
        raise AssertionError(f"{tag}: {len(widths)} decode chunks, want "
                             f"{per} per group of {FAM_MAX_BATCH}")

    def run(attend, **more):
        return in_batches(torch, lambda ps, ss, g: replay(
            torch, cfg, eng.params, ps, ss, attend, device,
            widths=widths[g * per:(g + 1) * per], **kw, **more),
            prompts, streams)

    ker, plain = replay_pair(
        torch, cfg, lambda: run(paged_attention),
        lambda: run(paged_attention_ref, prefill_attend=attention_ref), tag)
    check_agreement(torch, tag, ker, plain, streams, device)


def replay_ref_paged(torch, cfg, params, prompts, streams, device, *,
                     capacity, max_new, extras, widths):
    """Teacher-forced per-step logits [n, max_new, V] (f32) of a paged drain
    on the ``kv_impl="reference"`` read path, its arithmetic exactly: each
    prompt's flash prefill written into the pool, then per step and slot
    the slot's pages gathered at the drain's table width (``widths``, one
    per decode chunk) and ``decode_step`` at batch 1 on them."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batch import (gather_pages, scatter_token,
                                         slice_token, tail_targets,
                                         write_prefill)

    n, pages = len(prompts), capacity // BLOCK_SIZE
    shape = (n * pages + 1, BLOCK_SIZE, cfg.n_layers, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"kv": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for k in ("k", "v")}}
    tables = torch.arange(n * pages, dtype=torch.int32,
                          device=device).reshape(n, pages)
    first = []
    for i, p in enumerate(prompts):
        kw = extras(torch.as_tensor(p[None], device=device))
        at_site([("pre", i)])
        lg, cache = prefill(cfg, params, kw.pop("tokens"), capacity, **kw)
        write_prefill(pool, cache, tables[i], block_size=BLOCK_SIZE)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)]
    idx = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    for t in range(max_new - 1):
        tab = tables[:, :widths[t // DECODE_CHUNK]].contiguous()
        logits, writes = [], []
        for i in range(n):
            at_site([("dec", i, t)])
            lg, new = decode_step(
                cfg, params, torch.as_tensor([[streams[i][t]]],
                                             dtype=torch.int32,
                                             device=device),
                {**gather_pages(pool, tab[i]), "idx": idx[i]})
            logits.append(lg[0, -1].float())
            writes.append(slice_token(new, idx[i]))
        blk, off = tail_targets(tab, idx, live, BLOCK_SIZE, n * pages)
        scatter_token(pool, {"kv": {name: torch.stack(
            [w["kv"][name] for w in writes]) for name in ("k", "v")}},
            blk, off)
        steps.append(torch.stack(logits))
        idx = idx + 1
    return torch.stack(steps, dim=1)


def check_moe_paths(torch, tag, cfg, prompts, a, b, run_a, run_b, device):
    """Two drains of the moe family on two computations of one model (the
    paged kernel and reference read paths; slots batched and one request at
    a time): ``run_a(prompts, streams)`` and ``run_b`` replay each path's
    arithmetic exactly, teacher-forced. Each drain's streams must be its
    own path's greedy output (every served token within ``TOL_REPLAY`` of
    its replay's argmax logit). Where the drains' streams differ, both
    paths replay each differing stream with b's routing pinned to a's: the
    logits must agree within ``TOL_REPLAY`` and every routing b would have
    chosen otherwise must be a near-tie (:func:`replay_pair`). So the paths
    differ by bf16 rounding and by the routing near-ties it tips, which
    then send a stream along other experts."""
    for what, run, streams in (("a", run_a, a), ("b", run_b, b)):
        gap = served_gap(torch, run(prompts, streams), streams, device)
        print(f"{tag} drain {what}: each served token within {gap:.4f} of "
              f"its own path's replayed argmax logit (tol {TOL_REPLAY})")
        if gap > TOL_REPLAY:
            raise AssertionError(f"{tag}: drain {what} is not its own "
                                 "path's greedy output")
    differ = [i for i in range(len(a)) if a[i] != b[i]]
    print(f"{tag} {len(differ)} of {len(a)} streams differ")
    for streams in (a, b):
        if not differ:
            break
        sel_p = [prompts[i] for i in differ]
        sel_s = [streams[i] for i in differ]
        la, lb = replay_pair(torch, cfg, lambda: run_a(sel_p, sel_s),
                             lambda: run_b(sel_p, sel_s), tag)
        diff = float((la - lb).abs().max())
        print(f"{tag} with b's routing pinned to a's, max |logits a - b| "
              f"{diff:.4f} (tol {TOL_REPLAY})")
        if diff > TOL_REPLAY:
            raise AssertionError(f"{tag}: the paths differ beyond bf16 "
                                 "rounding once routed alike")


def slots_plain(torch, cfg, eng, device, **shape):
    """``replay_fn`` for :func:`check_same_or_near_tie` on continuous
    streams: :func:`replay_slots` through the plain attention."""
    from repro_torch.kernels import attention_ref

    return lambda ps, ss: replay_slots(torch, cfg, eng.params, ps, ss,
                                       attention_ref, device,
                                       extras=eng._prefill_inputs, **shape)


def leaves(tree) -> list:
    """The tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def damp_(torch, params, first, factor):
    """:func:`damped`, in place: every layer from ``first`` on scaled by
    ``factor`` (phase 16's targets are too large to copy)."""
    for leaf in leaves(params["layers"]):
        leaf[first:] *= factor
    return params


def check_phi(torch, card, cfg, params, device, rows):
    """Phase 16 (a): phi3.5-moe (8 of 32 layers, 16 experts of d_ff 6 400,
    top-2) on phase 15's 8 requests, ``max_new`` 16, 4 slots: continuous
    (against the drain one request at a time), paged on the kernel and the
    reference read paths (without prefix sharing), then speculative (its
    first 2 layers the draft of the damped target, k 3). The pairs of
    drains are compared by :func:`check_moe_paths`: an MoE routing
    near-tie, tipped by bf16 rounding, sends a stream along other
    experts."""
    from repro_torch.kernels import ops, paged_attention
    from repro_torch.serve import SpecConfig
    from repro_torch.weights import truncate_params

    prompts = workload(cfg.vocab, n=QW_REQUESTS)
    shape = {"capacity": QW_CAPACITY, "max_new": FAM_MAX_NEW}
    cont = dict(mode="continuous", capacity=QW_CAPACITY,
                max_batch=FAM_MAX_BATCH, decode_chunk=DECODE_CHUNK)
    # no shared prefixes: an MoE prefill routes its prompt jointly, so a
    # prefix's K/V depend on the whole prompt's length (through the
    # capacity and the drops), and another request's are not this one's
    # (the reference shares them all the same); the replays compute each
    # request's own
    paged = {**cont, "mode": "paged", "block_size": BLOCK_SIZE,
             "share_prefix": False}
    dense = partial(family_want, cfg)

    eng, streams, m = serve_family(
        torch, card, "[16a] phi continuous", cfg, params, device, prompts,
        FAM_MAX_NEW, lambda st: dense({**st, "mode": "continuous"},
                                      kernel=False), **cont)
    check_slots(torch, "[16a] phi continuous", cfg, eng, prompts, streams,
                device, **shape)
    _, serial, _ = serve_family(
        torch, card, "[16a] phi one request at a time", cfg, params, device,
        prompts, FAM_MAX_NEW, lambda st: dense({**st, "mode": "continuous"},
                                               kernel=False),
        **{**cont, "max_batch": 1})
    kw = {"extras": eng._prefill_inputs, **shape}

    def slots(size):
        return lambda ps, ss: in_batches(torch, lambda p, s, _: replay_slots(
            torch, cfg, eng.params, p, s, ops.attention, device, **kw), ps,
            ss, size)

    check_moe_paths(torch, "[16a] phi continuous vs serial", cfg, prompts,
                    streams, serial, slots(FAM_MAX_BATCH), slots(1), device)
    del eng

    eng, kernel, m = serve_family(
        torch, card, "[16a] phi paged kernel", cfg, params, device, prompts,
        FAM_MAX_NEW, lambda st: dense(st), kv_impl="kernel", **paged)
    rows["decode phi"]["launches"] = m["launches"]
    rows["flash phi"]["launches"] = m["flash_launches"]
    check_paged(torch, "[16a] phi paged kernel", cfg, eng, prompts, kernel,
                m["widths"], device, **shape)
    profile_drain(torch, eng, cfg.vocab, lambda st: dense(st), tag="[16a]")
    extras, widths = eng._prefill_inputs, m["widths"]
    del eng
    eng, ref_streams, m = serve_family(
        torch, card, "[16a] phi paged reference", cfg, params, device,
        prompts, FAM_MAX_NEW, lambda st: dense(st, kernel=False),
        kv_impl="reference", **paged)
    per = -(-(FAM_MAX_NEW - 1) // DECODE_CHUNK)   # chunks per group

    def run_kernel(ps, ss):
        return in_batches(torch, lambda p, s, g: replay(
            torch, cfg, eng.params, p, s, paged_attention, device,
            widths=widths[g * per:(g + 1) * per], **kw), ps, ss)

    def run_reference(ps, ss):
        return in_batches(torch, lambda p, s, g: replay_ref_paged(
            torch, cfg, eng.params, p, s, device,
            widths=m["widths"][g * per:(g + 1) * per], **kw), ps, ss)

    check_moe_paths(torch, "[16a] phi paged kernel vs reference", cfg,
                    prompts, kernel, ref_streams, run_kernel, run_reference,
                    device)
    del eng

    target = damp_(torch, params, SPEC_DRAFT_LAYERS, SPEC_DAMP)
    eng, base, _ = serve_family(
        torch, card, "[16a] phi damped paged", cfg, target, device, prompts,
        FAM_MAX_NEW, lambda st: dense(st), **paged)
    del eng
    spec = SpecConfig(cfg.with_overrides(n_layers=SPEC_DRAFT_LAYERS),
                      truncate_params(target, SPEC_DRAFT_LAYERS), k=SPEC_K)
    rounds = spec.rounds_for(DECODE_CHUNK)
    eng, streams, m = serve_family(
        torch, card, "[16a] phi speculative", cfg, target, device, prompts,
        FAM_MAX_NEW, lambda st: dense(
            st, rounds=st["decode_dispatches"] * rounds), speculate=spec,
        **paged)
    print(f"[16a] phi speculative: accepted {m['spec_accepted']} of "
          f"{m['spec_proposed']} proposed")
    if not 0 < m["spec_accepted"] <= m["spec_proposed"]:
        raise AssertionError("phi speculative: no draft accepted")
    check_spec_replay(torch, cfg, eng.params, prompts, streams, base, device,
                      tag="[16a] phi speculative", extras=extras, **shape)


def check_grok(torch, card, cfg, params, device, rows):
    """Phase 16 (b): grok-1 (2 of 64 layers, 8 experts of d_ff 32 768,
    soft-cap 30), a continuous drain of 4 requests, replayed
    teacher-forced; every logit within the soft-cap."""
    prompts = workload(cfg.vocab, n=QW_REQUESTS)[:GROK_REQUESTS]
    shape = {"capacity": QW_CAPACITY, "max_new": FAM_MAX_NEW}
    eng, streams, m = serve_family(
        torch, card, "[16b] grok continuous", cfg, params, device, prompts,
        FAM_MAX_NEW, lambda st: family_want(cfg, {**st, "mode":
                                                  "continuous"},
                                            kernel=False),
        mode="continuous", capacity=QW_CAPACITY, max_batch=FAM_MAX_BATCH,
        decode_chunk=DECODE_CHUNK)
    plain = check_slots(torch, "[16b] grok continuous", cfg, eng, prompts,
                        streams, device, **shape)
    top = float(plain.abs().max())
    print(f"[16b] grok |logit| max {top:.3f} (soft-cap "
          f"{cfg.logits_softcap})")
    if top > cfg.logits_softcap:
        raise AssertionError("grok: a logit past the soft-cap")


def chameleon_workload(vocab):
    """Phase 16 (c)'s prompts: CH_REQUESTS seeded prompts of 1 100-1 400
    tokens, longer than the 1 024 image positions the engine fuses."""
    rng = np.random.default_rng(SEED + 16)
    return [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(*CH_PROMPT_LENS, size=CH_REQUESTS)]


def check_chameleon(torch, card, cfg, params, device, rows):
    """Phase 16 (c): chameleon-34b (16 of 48 layers), 4 requests of
    1 100-1 400 tokens: paged on the kernel path (replayed
    teacher-forced), continuous (against the paged streams), then
    speculative at k 8 (its first 2 layers the draft of the damped target):
    a verify window of 9 rows x 8 heads per KV head, 72 rows, which the
    repaired window kernel takes."""
    from repro_torch.serve import SpecConfig
    from repro_torch.weights import truncate_params

    prompts = chameleon_workload(cfg.vocab)
    shape = {"capacity": CH_CAPACITY, "max_new": FAM_MAX_NEW}
    paged = dict(mode="paged", capacity=CH_CAPACITY, max_batch=FAM_MAX_BATCH,
                 block_size=BLOCK_SIZE, decode_chunk=DECODE_CHUNK)
    dense = partial(family_want, cfg)
    eng, kernel, m = serve_family(
        torch, card, "[16c] chameleon paged kernel", cfg, params, device,
        prompts, FAM_MAX_NEW, lambda st: dense(st), **paged)
    rows["decode chameleon"]["launches"] = m["launches"]
    rows["flash chameleon"]["launches"] = m["flash_launches"]
    check_paged(torch, "[16c] chameleon paged kernel", cfg, eng, prompts,
                kernel, m["widths"], device, **shape)
    profile_drain(torch, eng, cfg.vocab, lambda st: dense(st), tag="[16c]")
    extras = eng._prefill_inputs
    del eng
    eng, streams, _ = serve_family(
        torch, card, "[16c] chameleon continuous", cfg, params, device,
        prompts, FAM_MAX_NEW, lambda st: dense({**st, "mode": "continuous"},
                                               kernel=False),
        **{**paged, "mode": "continuous"})
    check_same_or_near_tie(torch, "[16c] chameleon continuous vs paged",
                           cfg, eng.params, prompts, streams, kernel, device,
                           extras=extras, **shape)
    del eng

    target = damp_(torch, params, SPEC_DRAFT_LAYERS, SPEC_DAMP)
    eng, base, _ = serve_family(
        torch, card, "[16c] chameleon damped paged", cfg, target, device,
        prompts, FAM_MAX_NEW, lambda st: dense(st), **paged)
    del eng
    spec = SpecConfig(cfg.with_overrides(n_layers=SPEC_DRAFT_LAYERS),
                      truncate_params(target, SPEC_DRAFT_LAYERS),
                      k=CH_SPEC_K)
    rounds = spec.rounds_for(DECODE_CHUNK)
    eng, streams, m = serve_family(
        torch, card, "[16c] chameleon speculative k 8", cfg, target, device,
        prompts, FAM_MAX_NEW, lambda st: dense(
            st, rounds=st["decode_dispatches"] * rounds), speculate=spec,
        **paged)
    rows["verify chameleon"]["launches"] = m["multi_launches"]
    print(f"[16c] chameleon speculative k 8: accepted {m['spec_accepted']} "
          f"of {m['spec_proposed']} proposed")
    check_spec_replay(torch, cfg, eng.params, prompts, streams, base, device,
                      tag="[16c] chameleon k 8", k=CH_SPEC_K, extras=extras,
                      **shape)


def check_whisper(torch, card, cfg, params, device, rows):
    """Phase 16 (d): whisper-tiny whole (4 encoder and 4 decoder layers,
    1 500 source frames), 8 requests, 4 slots: continuous (replayed
    teacher-forced, and against the drain one request at a time) and the
    cohort drain (replayed teacher-forced)."""
    from repro_torch.kernels import attention_ref, ops

    prompts = workload(cfg.vocab, n=QW_REQUESTS)
    shape = {"capacity": QW_CAPACITY, "max_new": FAM_MAX_NEW}
    cont = dict(mode="continuous", capacity=QW_CAPACITY,
                max_batch=FAM_MAX_BATCH, decode_chunk=DECODE_CHUNK)
    want = partial(family_want, cfg)
    eng, streams, m = serve_family(
        torch, card, "[16d] whisper continuous", cfg, params, device,
        prompts, FAM_MAX_NEW, lambda st: want({**st, "mode": "continuous"}),
        **cont)
    rows["flash whisper encoder"]["launches"] = \
        cfg.n_enc_layers * (1 + m["prefills"])
    rows["flash whisper cross"]["launches"] = cfg.n_layers * m["prefills"]
    check_slots(torch, "[16d] whisper continuous", cfg, eng, prompts,
                streams, device, **shape)
    profile_drain(torch, eng, cfg.vocab, lambda st: want(
        {**st, "mode": "continuous"}), tag="[16d]")
    _, serial, _ = serve_family(
        torch, card, "[16d] whisper one request at a time", cfg, params,
        device, prompts, FAM_MAX_NEW,
        lambda st: want({**st, "mode": "continuous"}),
        **{**cont, "max_batch": 1})
    check_same_or_near_tie(torch, "[16d] whisper continuous vs serial", cfg,
                           eng.params, prompts, streams, serial, device,
                           replay_fn=slots_plain(torch, cfg, eng, device,
                                                 **shape), **shape)
    extras = eng._prefill_inputs
    del eng
    eng, cohort, m = serve_family(
        torch, card, "[16d] whisper cohort", cfg, params, device, prompts,
        FAM_MAX_NEW, lambda st: want({**st, "mode": "cohort"}),
        mode="cohort", capacity=QW_CAPACITY, max_batch=FAM_MAX_BATCH)
    kw = {"max_batch": FAM_MAX_BATCH, "extras": extras, **shape}
    check_agreement(torch, "[16d] whisper cohort", replay_cohort(
        torch, cfg, eng.params, prompts, cohort, ops.attention, device,
        **kw), replay_cohort(torch, cfg, eng.params, prompts, cohort,
                             attention_ref, device, **kw), cohort, device)


def check_families(torch, card, device, flash_rows):
    """Phase 16: the new kernel shapes, then each family's configs served
    at their published widths (depth cut as ``FAM_DEPTH`` says), one model
    on the card at a time, freed before the next. ``flash_rows``:
    :func:`check_flash_kernel`'s entries for :func:`family_flash_cases`,
    in order. Prints the rows it measured, with their launches, as one
    JSON line."""
    from repro_torch.models import init_params

    from repro_torch.configs import get

    cfgs = family_configs()
    for arch, c in cfgs.items():
        whole = get(arch).config.n_layers
        print(f"[16] {arch}: {c.n_layers} of {whole} layers, d_model "
              f"{c.d_model}, {c.n_heads}/{c.n_kv_heads} heads of "
              f"{c.head_dim}, d_ff {c.d_ff}, vocab {c.vocab}"
              + (f", {c.n_experts} experts top-{c.top_k}" if c.n_experts
                 else "")
              + (f", soft-cap {c.logits_softcap}" if c.logits_softcap
                 else "")
              + (f", {c.n_img_tokens} image positions" if c.n_img_tokens
                 else "")
              + (f", {c.n_enc_layers} encoder layers over {c.src_len} "
                 "frames" if c.is_encdec else "")
              + f", {c.param_count() / 1e9:.2f} B parameters")
    t0 = time.perf_counter()
    rows = family_paged_rows(torch, cfgs)
    rows.update(zip(("flash whisper encoder", "flash whisper cross",
                     "flash phi", "flash chameleon"), flash_rows,
                    strict=True))
    print(f"[16 rows] took {time.perf_counter() - t0:.1f} s", flush=True)
    for part, arch, fn in (("a", PHI_ARCH, check_phi),
                           ("b", GROK_ARCH, check_grok),
                           ("c", CH_ARCH, check_chameleon),
                           ("d", WH_ARCH, check_whisper)):
        t0 = time.perf_counter()
        params = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfgs[arch], torch.Generator(
            device=device).manual_seed(SEED), device=device)
        weights = sum(t.numel() * t.element_size() for t in leaves(params))
        fn(torch, card, cfgs[arch], params, device, rows)
        print(f"[16{part}] {arch} took {time.perf_counter() - t0:.1f} s, "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f}"
              f" GiB, weights {weights / 2 ** 30:.1f} GiB; {card}",
              flush=True)
    del params
    torch.cuda.empty_cache()
    print("[16 rows] " + json.dumps(rows) + f" {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import init_params

    t_start = time.perf_counter()
    t_lap = [t_start]
    # phase 18's dry runs trace on the CPU while phases 2-17 use the card;
    # the worker is joined at phase 18, or at exit
    dry_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    dry = dry_pool.submit(dry_run_worker, DRY_ARCHS, (TR_K, TR_BATCH, TR_SEQ))

    def lap(tag):
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        print(f"{tag} phase took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    # the profiler's first start in a process takes seconds: pay it while
    # nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(build.build, KERNEL_SOURCES)
        t_warm = time.perf_counter()
        warm_up_profiler(torch)
        t_warm = time.perf_counter() - t_warm
        logs = building.result()
    print(f"[2] built {', '.join(KERNEL_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s (the profiler's first start, "
          f"{t_warm:.1f} s, beside it)")
    for line in ptxas_report(logs) + sass_report(build):
        print(f"[2] {line}")
    lap("[2]")

    cfg = get(ARCH).config
    kernels = [check_kernels(torch, cfg)]
    kernels.append(check_multi_kernel(torch, cfg))
    lap("[3, 7a]")

    device = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device=device)
    eng, prompts, streams, metrics = serve(torch, cfg, params, device)
    check_serve(cfg, streams, metrics)
    kernels[0]["launches"] = metrics["launches"]
    print("[4] " + json.dumps({k: metrics[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "launches", "flash_launches", "decode_steps", "decode_dispatches",
        "prefills", "preemptions", "prefix_hits", "cow_forks",
        "peak_shared_blocks", "peak_concurrency", "peak_blocks_in_use",
        "prefill_s")}))
    lap("[4]")

    check_replay(torch, cfg, eng.params, prompts, streams, device)
    lap("[5]")
    profile_drain(torch, eng, cfg.vocab, lambda st: paged_want(cfg, st))
    lap("[6]")
    del eng

    spec_eng, prompts, spec_streams, base, m, bm = spec_drain(
        torch, cfg, params, device)
    check_spec(cfg, spec_streams, m)
    check_serve(cfg, base, bm)
    kernels[1]["launches"] = m["multi_launches"]
    print("[7b] spec " + json.dumps({k: m[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "spec_proposed", "spec_accepted", "acceptance", "spec_rounds",
        "spec_full_rounds", "draft_prefills", "decode_dispatches", "rounds",
        "preemptions", "prefills", "prefix_hits", "multi_launches",
        "launches", "flash_launches", "prefill_s")}))
    print("[7b] non-spec, same target " + json.dumps({k: bm[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "decode_dispatches", "preemptions", "launches")}))
    check_spec_replay(torch, cfg, spec_eng.params, prompts, spec_streams,
                      base, device)
    rounds = spec_eng.spec.rounds_for(DECODE_CHUNK)
    profile_drain(torch, spec_eng, cfg.vocab, lambda st: paged_want(
        cfg, st, rounds=st["decode_dispatches"] * rounds), tag="[7b]")
    lap("[7b]")
    del spec_eng, params
    torch.cuda.empty_cache()

    hcfg = get(HYBRID_ARCH).config
    kernels.append(check_flash_kernel(torch)[0])
    lap("[8]")
    kernels.append(check_rglru_kernel(torch, hcfg.lru_width, card))
    lap("[9]")
    hparams = init_params(hcfg, torch.Generator(
        device="cuda").manual_seed(SEED), device=device)
    h_eng, h_prompts, h_streams, hm = serve_continuous(
        torch, hcfg, hparams, device, lambda st: hybrid_want(hcfg, st),
        "continuous hybrid drain")
    kernels[2]["launches"] = hm["counts"]["flash_attention"]
    kernels[3]["launches"] = hm["counts"]["rglru_scan"]
    print("[10] " + json.dumps({k: hm[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "prefill_s", "prompt_tokens", "prefills", "decode_steps",
        "decode_dispatches", "peak_concurrency", "counts")}))
    lap("[10] serve")
    check_replay_hybrid(torch, hcfg, h_eng.params, h_prompts, h_streams,
                        device)
    lap("[10] replay")
    profile_drain(torch, h_eng, hcfg.vocab,
                  lambda st: hybrid_want(hcfg, st), tag="[10]")
    lap("[10] profile")
    del h_eng, hparams
    torch.cuda.empty_cache()

    scfg = get(SSM_ARCH).config
    kernels.append(check_wkv_kernel(torch, scfg, card))
    lap("[11a]")
    sparams = init_params(scfg, torch.Generator(
        device="cuda").manual_seed(SEED), device=device)
    s_eng, s_prompts, s_streams, sm = serve_continuous(
        torch, scfg, sparams, device, lambda st: ssm_want(scfg, st),
        "continuous rwkv6 drain")
    kernels[4]["launches"] = sm["counts"]["wkv6_scan"]
    print("[11] " + json.dumps({k: sm[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "prefill_s", "prompt_tokens", "prefills", "decode_steps",
        "decode_dispatches", "peak_concurrency", "plain_wkv_runs",
        "counts")}))
    lap("[11] serve")
    check_replay_ssm(torch, scfg, s_eng.params, s_prompts, s_streams,
                     device)
    lap("[11] replay")
    profile_drain(torch, s_eng, scfg.vocab, lambda st: ssm_want(scfg, st),
                  tag="[11]")
    lap("[11] profile")
    del s_eng, sparams
    torch.cuda.empty_cache()

    check_bilevel(torch, card)
    lap("[12]")
    trainer = check_trainer(torch, card)
    lap("[13]")
    check_gossip(torch, card, trainer)
    lap("[14]")
    torch.cuda.empty_cache()
    flash_rows = check_flash_kernel(torch, dense_flash_cases(), tag="[15]",
                                    seed=SEED + 16)
    check_dense_configs(torch, card, device, flash_rows)
    lap("[15]")
    flash_rows = check_flash_kernel(
        torch, family_flash_cases(family_configs()), tag="[16]",
        seed=SEED + 17)
    check_families(torch, card, device, flash_rows)
    lap("[16]")
    check_whisper_trainer(torch, card)
    lap("[17]")
    dry_runs = dry.result()
    dry_pool.shutdown()
    check_dry_run(torch, card, dry_runs)
    lap("[18]")
    print(f"[ ] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
