"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase is caught):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every CUDA kernel of the serving paths from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (sm_90a; one ``nvcc`` per source, all
   started together), timed;
3. hold the paged decode kernel against its plain PyTorch version at the
   serving path's shapes (bf16) and at a small f32 shape — dead slots, tail
   pages and aliased pages included — and time both with CUDA events;
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
   and the window kernel and the scan not at all;
7. speculative decoding: (a) hold the verify-window kernel against its
   plain version at the speculative path's shapes (bf16, windows crossing
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
8. hold the flash-attention kernel against its plain version at both
   prefill shapes — (a) recurrentgemma-2b's: 10 query heads over one KV
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
   names as often as their wrappers counted.

Prints a ``{"kernels": [...]}`` line naming all four kernels, then the
card's name and power limit, and as its last line ``{"ok": true,
"device": {...}}``. Needs a CUDA card
and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

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
KERNEL_SOURCES = ("paged_attention", "flash_attention", "rglru_scan")
# each kernel wrapper's __global__ function, as a profiler trace names it
KERNEL_SYMBOLS = {"paged_attention": "paged_attention_decode_kernel",
                  "paged_attention_multi": "paged_attention_multi_kernel",
                  "flash_attention": "flash_attention_kernel",
                  "rglru_scan": "rglru_scan_kernel"}
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


def workload(vocab):
    """16 seeded prompts of 17–300 tokens; requests 1 and 3 share a
    128-token prefix."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=N_REQUESTS)
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
                label = f"{sym}<{dtype}{', ' + dh.group(1) if dh else ''}>"
                out.append(label + ":")
            elif label and ("registers" in line or "spill" in line):
                out[-1] += " " + line.split(":", 1)[-1].strip() + ";"
    return out


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

    eng = ServeEngine(cfg, params, capacity=CAPACITY, max_batch=MAX_BATCH,
                      block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                      decode_chunk=DECODE_CHUNK, speculate=speculate,
                      device=device)
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


def replay(torch, cfg, params, prompts, streams, attend, device):
    """Teacher-forced per-step logits [n, MAX_NEW, V] (f32): prefill, then
    each served token fed back through ``paged_decode_step``."""
    from repro_torch.models import prefill
    from repro_torch.models.paged import paged_decode_step
    from repro_torch.serve.batch import tail_targets, write_prefill

    n, pages = len(prompts), CAPACITY // BLOCK_SIZE
    shape = (n * pages + 1, BLOCK_SIZE, cfg.n_layers, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"kv": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for k in ("k", "v")}}
    tables = torch.arange(n * pages, dtype=torch.int32,
                          device=device).reshape(n, pages)
    steps = []
    first = []
    for i, p in enumerate(prompts):
        lg, cache = prefill(cfg, params, torch.as_tensor(p[None],
                                                         device=device),
                            CAPACITY)
        write_prefill(pool, cache, tables[i], block_size=BLOCK_SIZE)
        first.append(lg[0, -1].float())
    steps.append(torch.stack(first))
    idx = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    for t in range(MAX_NEW - 1):
        tok = torch.as_tensor([s[t] for s in streams], dtype=torch.int32,
                              device=device)
        blk, off = tail_targets(tables, idx, live, BLOCK_SIZE, n * pages)
        lg, _ = paged_decode_step(cfg, params, tok, pool["kv"], tables, blk,
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


def profile_drain(torch, eng, vocab, want_fn, tag="[6]"):
    """Phase 6 (and 7b, 10): where the time goes. One more drain (8
    requests of 64 prompt tokens, one decode chunk each) under
    ``torch.profiler``: wall time, the card's busy time, and the kernels
    that took it. ``want_fn(stats)`` gives the launches this drain's path
    must make of each kernel (its stats in hand); every kernel's wrapper
    must count exactly that, the trace must show each kernel under its own
    name as often, and the kernels of other paths not at all."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, vocab, size=64).astype(np.int32),
                   max_new_tokens=DECODE_CHUNK + 1)
    torch.cuda.synchronize()
    reset_counts()
    # the card's activity only: the busy share and the kernel counts need
    # nothing else, and the host's operator events would double the trace
    # and its parsing time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = read_counts()
    # device-side events only (kernels, copies), not the runtime calls on
    # the host that launched them
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no time on the card")
    rows.sort(key=lambda r: -r[1])
    print(f"{tag} profiled drain: wall {wall_ms:.1f} ms, card busy "
          f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), decode steps "
          f"{eng.stats['decode_steps']}, prefills {eng.stats['prefills']}")
    for key, ms, count in rows[:8]:
        print(f"{tag}   {ms:9.3f} ms  {count:6d} x  {key[:90]}")
    traced = {name: [(ms, count) for key, ms, count in rows if sym in key]
              for name, sym in KERNEL_SYMBOLS.items()}
    n_traced = {name: sum(c for _, c in t) for name, t in traced.items()}
    want = want_fn(eng.stats)
    for name in want:
        k_ms = sum(ms for ms, _ in traced[name])
        print(f"{tag}   {name} ({KERNEL_SYMBOLS[name]}): {k_ms:.3f} ms in "
              f"{n_traced[name]} launches ({k_ms / busy_ms:.1%} of the "
              f"card's busy time)")
    check_counts(f"{tag} profiled drain, counted", counted, want)
    check_counts(f"{tag} profiled drain, traced", n_traced, want)
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


def replay_windows(torch, cfg, params, prompts, streams, attend, device):
    """Teacher-forced per-step logits [n, MAX_NEW, V] (f32) through the
    verify step: prefill, then the served tokens fed back in windows of
    k + 1 through ``paged_verify_step``."""
    from repro_torch.models import prefill
    from repro_torch.models.paged import paged_verify_step
    from repro_torch.serve.batch import tail_targets_multi, write_prefill

    n, pages = len(prompts), CAPACITY // BLOCK_SIZE
    shape = (n * pages + 1, BLOCK_SIZE, cfg.n_layers, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"kv": {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
                   for k in ("k", "v")}}
    tables = torch.arange(n * pages, dtype=torch.int32,
                          device=device).reshape(n, pages)
    first = []
    for i, p in enumerate(prompts):
        lg, cache = prefill(cfg, params, torch.as_tensor(p[None],
                                                         device=device),
                            CAPACITY)
        write_prefill(pool, cache, tables[i], block_size=BLOCK_SIZE)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)[:, None]]
    idx = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    served = torch.as_tensor(streams, dtype=torch.int32, device=device)
    for t0 in range(0, MAX_NEW - 1, SPEC_K + 1):
        Q = min(SPEC_K + 1, MAX_NEW - 1 - t0)
        blks, offs = tail_targets_multi(tables, idx, live, Q, BLOCK_SIZE,
                                        n * pages)
        pos = idx[:, None] + torch.arange(Q, dtype=torch.int32,
                                          device=device)
        lg, _ = paged_verify_step(cfg, params,
                                  served[:, t0:t0 + Q].contiguous(),
                                  pool["kv"], tables, blks, offs, pos,
                                  idx + Q, attend=attend)
        steps.append(lg.float())
        idx = idx + Q
    return torch.cat(steps, dim=1)


def check_spec_replay(torch, cfg, params, prompts, streams, base, device):
    """Phase 7b: spec streams that differ from the non-speculative ones
    (near-ties in bf16) must be what the plain attention would serve."""
    from repro_torch.kernels import paged_attention_multi, \
        paged_attention_multi_ref

    differ = [i for i in range(len(streams)) if streams[i] != base[i]]
    if not differ:
        print("[7b] every speculative stream equals its non-speculative "
              "stream")
        return
    sel_p = [prompts[i] for i in differ]
    sel_s = [streams[i] for i in differ]
    ker = replay_windows(torch, cfg, params, sel_p, sel_s,
                         paged_attention_multi, device)
    plain = replay_windows(torch, cfg, params, sel_p, sel_s,
                           paged_attention_multi_ref, device)
    diff = float((ker - plain).abs().max())
    served = torch.as_tensor(sel_s, device=device).long()
    served_logit = plain.gather(-1, served[..., None])[..., 0]
    gap = float((plain.max(-1).values - served_logit).max())
    print(f"[7b] {len(differ)} of {len(streams)} speculative streams differ "
          f"from the non-speculative ones; window replay: max |logits "
          f"kernel - plain| {diff:.4f} (tol {TOL_REPLAY}); served token "
          f"within {gap:.4f} of the plain argmax logit (tol {TOL_REPLAY})")
    if not torch.isfinite(ker).all() or diff > TOL_REPLAY \
            or gap > TOL_REPLAY:
        raise AssertionError("spec replay: the served streams disagree with "
                             "the plain attention beyond the bf16 tolerance")


# ---------------------------------------------------------------------------
# Phases 8-10: the prefill kernels and continuous serving of recurrentgemma
# ---------------------------------------------------------------------------

def flash_case(torch, gen, *, B, H, Hkv, S, Dh, dtype):
    """q ``[B, H, S, Dh]`` and k/v ``[B, Hkv, S, Dh]`` on the card, each a
    ``[B, S, heads, Dh]`` tensor viewed in the kernel's layout, as the
    model hands them over."""
    def one(heads):
        return torch.randn((B, S, heads, Dh), generator=gen,
                           device="cuda").to(dtype).transpose(1, 2)
    return one(H), one(Hkv), one(Hkv)


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


def check_flash_kernel(torch):
    """Phase 8: the flash-attention kernel vs its plain version at both
    prefill shapes of the serving paths — (a) recurrentgemma-2b's (10 query
    heads over one KV head, Dh 256, the 2 048 window, a 2 300-token prompt)
    and (b) smollm-360m's (15 over 5, Dh 64, causal, 300 tokens) — and at
    edge cases; each timed beside the plain version and the library
    yardstick. Returns the kernels-line entry of (a)."""
    from repro_torch.kernels import attention_ref, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, H, Hkv, S, Dh, dtype, causal, window)
    cases = [
        ("a recurrentgemma-2b", 1, 10, 1, 2300, 256, bf16, True, 2048),
        ("b smollm-360m", 1, 15, 5, 300, 64, bf16, True, None),
        ("S 100 (tail tile)", 1, 10, 1, 100, 256, bf16, True, 64),
        ("S 37 < one tile", 1, 15, 5, 37, 64, bf16, True, None),
        ("window 1", 1, 10, 1, 300, 256, bf16, True, 1),
        ("non-causal", 2, 4, 2, 200, 128, bf16, False, None),
        ("f32, window 64", 1, 10, 1, 300, 256, f32, True, 64),
        ("f32 smollm heads", 1, 15, 5, 300, 64, f32, True, None),
    ]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    entry = None
    for label, B, H, Hkv, S, Dh, dtype, causal, window in cases:
        q, k, v = flash_case(torch, gen, B=B, H=H, Hkv=Hkv, S=S, Dh=Dh,
                             dtype=dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        excess = within_limit(out, ref)
        tol = (f"{TOL_F32}" if dtype == f32
               else f"{BF16_ATOL} + {BF16_RTOL} |plain|")
        print(f"[8] flash_attention {label}: B={B} H={H} Hkv={Hkv} S={S} "
              f"Dh={Dh} {str(dtype)[6:]} causal={causal} window={window}: "
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
            print(f"[8] flash_attention {label}: the library without its "
                  f"window exceeds the limit by {no_window:.3e}")
            if not no_window > 0:
                raise AssertionError(f"{label}: the library check does not "
                                     f"tell a missing window mask")
        bound, bound_by = attention_bound_ms(q, k, causal, window)
        lib_tol = (tol if dtype == f32
                   else f"{tol} + {LIB_P_RTOL} plain(|v|)")
        print(f"[8] flash_attention {label}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library (scaled_dot_product_attention, "
              f"max |library - plain| {lib_err:.3e}, tol {lib_tol}, "
              f"{lib_excess:.3e} past it) {library_ms:.4f} ms, "
              f"bound {bound:.5f} ms ({bound_by}), "
              f"{attention_pairs(S, S, causal, window)} pairs per head, "
              f"L2 cold")
        if entry is None:
            entry = {"name": "flash_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:98",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms}
    del flush
    return entry


def check_rglru_kernel(torch, R):
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
              f"library none, L2 cold")
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


def serve_hybrid(torch, cfg, params, device):
    """Phase 10: continuous serving of full-width recurrentgemma-2b. Returns
    (engine, prompts, streams, metrics); the prefill seconds are the
    card-synchronised time of each admission prefill, summed."""
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
    streams, m = drain(torch, eng, prompts, HYB_MAX_NEW)
    eng._prefill = prefill
    m["prefill_s"] = sum(prefill_s)
    m["prompt_tokens"] = sum(map(len, prompts))
    if any(len(s) != HYB_MAX_NEW for s in streams):
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        raise AssertionError("token out of the vocabulary")
    check_counts("continuous hybrid drain", m["counts"],
                 hybrid_want(cfg, m))
    return eng, prompts, streams, m


def replay_hybrid(torch, cfg, params, prompts, streams, attend, scan,
                  device):
    """Teacher-forced per-step logits [n, HYB_MAX_NEW, V] (f32): each
    prompt's prefill through ``attend`` and ``scan`` into a slot cache,
    then the served tokens fed back through the slot decode, every slot at
    its own position."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.batch import init_slot_cache, write_slot

    cache = init_slot_cache(cfg, len(prompts), HYB_CAPACITY, device=device)
    first = []
    for i, p in enumerate(prompts):
        lg, c = prefill(cfg, params, torch.as_tensor(p[None], device=device),
                        HYB_CAPACITY, attend=attend, scan=scan)
        write_slot(cache, c, i)
        first.append(lg[0, -1].float())
    steps = [torch.stack(first)]
    for t in range(HYB_MAX_NEW - 1):
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
    logs = build.build(KERNEL_SOURCES)
    print(f"[2] built {', '.join(KERNEL_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(logs):
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
    kernels.append(check_flash_kernel(torch))
    lap("[8]")
    kernels.append(check_rglru_kernel(torch, hcfg.lru_width))
    lap("[9]")
    hparams = init_params(hcfg, torch.Generator(
        device="cuda").manual_seed(SEED), device=device)
    h_eng, h_prompts, h_streams, hm = serve_hybrid(torch, hcfg, hparams,
                                                   device)
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
    print(f"[ ] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
