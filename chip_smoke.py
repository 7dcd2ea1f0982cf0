"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase is caught):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build every CUDA kernel of the serving path from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (sm_90a; one ``nvcc`` per source, all
   started together), timed;
3. hold each kernel against its plain PyTorch version at the serving path's
   shapes (bf16) and at a small f32 shape — dead slots, tail pages and
   aliased pages included — and time both with CUDA events;
4. serve full-width ``smollm-360m`` (random weights from a fixed
   ``torch.Generator``) through the paged ``ServeEngine``: 16 seeded
   requests, prompts of 17–300 tokens (two share a 128-token prefix),
   ``max_new`` 32, ``max_batch`` 8, ``block_size`` 16, and a pool tight
   enough to force preemption. The kernel launch count must equal
   ``n_layers`` x the decode steps run;
5. replay the served streams teacher-forced through the kernel and through
   the plain attention, and compare the per-step logits;
6. profile one more short drain with ``torch.profiler``: the card's busy
   share of the wall time and the kernels that took it; the trace must
   show the decode kernel as often as its wrapper counted, and the window
   kernel not at all;
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
   rounds run, the decode kernel must not launch, and some rounds must
   accept every draft and some not. Streams that differ from the
   non-speculative ones are replayed teacher-forced through the window
   kernel and through the plain attention. A profiled speculative drain
   must show the window kernel as often as its wrapper counted, and the
   decode kernel not at all.

Prints a ``{"kernels": [...]}`` line, then the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Needs a CUDA card
and the repository's ``src/`` beside this file.
"""
from __future__ import annotations

import json
import os
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
KERNEL_SOURCES = ("paged_attention",)   # csrc/<name>.cu, one nvcc each
# each kernel wrapper's __global__ function, as a profiler trace names it
KERNEL_SYMBOLS = {"paged_attention": "paged_attention_decode_kernel",
                  "paged_attention_multi": "paged_attention_multi_kernel"}
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
# where one bf16 ulp is 2**-6). The limit is 16 such ulps.
TOL_REPLAY = 0.25

# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def serve(torch, cfg, params, device, speculate=None):
    """Phase 4 (and 7b with ``speculate``): drive the paged engine; returns
    (engine, prompts, streams, metrics). Both kernels' launch counts are
    set to 0 just before the drain and read just after it."""
    from repro_torch.kernels import paged_attention, paged_attention_multi
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, capacity=CAPACITY, max_batch=MAX_BATCH,
                      block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                      decode_chunk=DECODE_CHUNK, speculate=speculate,
                      device=device)
    prompts = workload(cfg.vocab)
    paged_attention.launches = paged_attention_multi.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    results = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    multi_launches = paged_attention_multi.launches
    streams = [results[r] for r in rids]
    st = eng.stats
    ttft = [eng.completed[r].first_token_s - eng.completed[r].submit_s
            for r in rids]
    metrics = {"wall_s": wall, "tokens": sum(map(len, streams)),
               "tokens_per_s": sum(map(len, streams)) / wall,
               "ttft_p50_ms": float(np.median(ttft)) * 1e3,
               "ttft_max_ms": float(np.max(ttft)) * 1e3,
               "launches": launches, "multi_launches": multi_launches, **st}
    return eng, prompts, streams, metrics


def check_serve(cfg, streams, metrics):
    if any(len(s) != MAX_NEW for s in streams):
        raise AssertionError(f"stream lengths {[len(s) for s in streams]}")
    if not all(0 <= t < cfg.vocab for s in streams for t in s):
        raise AssertionError("token out of the vocabulary")
    if metrics["preemptions"] < 1:
        raise AssertionError("the pool did not force a preemption")
    if metrics["peak_shared_blocks"] < 1:
        raise AssertionError("no prompt prefix was shared")
    if metrics["multi_launches"]:
        raise AssertionError("the non-speculative path launched the "
                             "verify-window kernel")
    want = cfg.n_layers * metrics["decode_steps"]
    if not 0 < metrics["launches"] == want:
        raise AssertionError(f"paged_attention launched "
                             f"{metrics['launches']} times; the path ran "
                             f"{metrics['decode_steps']} decode steps x "
                             f"{cfg.n_layers} layers = {want}")


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


def profile_drain(torch, eng, vocab, tag="[6]", kernel="paged_attention"):
    """Phase 6 (and 7b): where the time goes. One more drain (8 requests of
    64 prompt tokens, one decode chunk each) under ``torch.profiler``: wall
    time, the card's busy time, and the kernels that took it. The trace
    must show ``kernel`` as many times as its wrapper counted launches in
    this drain, and the other paged-attention kernel not at all."""
    from repro_torch import kernels as K
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, vocab, size=64).astype(np.int32),
                   max_new_tokens=DECODE_CHUNK + 1)
    torch.cuda.synchronize()
    counted = {name: getattr(K, name).launches for name in KERNEL_SYMBOLS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = {name: getattr(K, name).launches - n
               for name, n in counted.items()}
    # device-side events only (kernels, copies): the operator rows above
    # them would count the same time twice
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
    attn_ms = sum(ms for ms, _ in traced[kernel])
    n_traced = {name: sum(c for _, c in t) for name, t in traced.items()}
    print(f"{tag}   {kernel} ({KERNEL_SYMBOLS[kernel]}): {attn_ms:.3f} ms "
          f"in {n_traced[kernel]} launches ({attn_ms / busy_ms:.1%} of the "
          f"card's busy time)")
    want = {name: counted[name] if name == kernel else 0
            for name in KERNEL_SYMBOLS}
    if not 0 < n_traced[kernel] or n_traced != want or counted != want:
        raise AssertionError(f"profiled drain: traced launches {n_traced}, "
                             f"counted {counted}; want {kernel} only")
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
    want = cfg.n_layers * m["rounds"]
    if not 0 < m["multi_launches"] == want:
        raise AssertionError(f"paged_attention_multi launched "
                             f"{m['multi_launches']} times; the path ran "
                             f"{m['rounds']} verify rounds x {cfg.n_layers} "
                             f"layers = {want}")
    if m["launches"]:
        raise AssertionError(f"the speculative path launched paged_attention "
                             f"{m['launches']} times; the draft attends "
                             "with sdpa")
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
    card = card_line()
    print(f"[1] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build(KERNEL_SOURCES)
    print(f"[2] built {', '.join(KERNEL_SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[2] {name}: {line.strip()}")

    cfg = get(ARCH).config
    kernels = [check_kernels(torch, cfg)]
    kernels.append(check_multi_kernel(torch, cfg))

    device = torch.device("cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device=device)
    eng, prompts, streams, metrics = serve(torch, cfg, params, device)
    check_serve(cfg, streams, metrics)
    kernels[0]["launches"] = metrics["launches"]
    print("[4] " + json.dumps({k: metrics[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "launches", "decode_steps", "decode_dispatches", "prefills",
        "preemptions", "prefix_hits", "cow_forks", "peak_shared_blocks",
        "peak_concurrency", "peak_blocks_in_use", "prefill_s")}))

    check_replay(torch, cfg, eng.params, prompts, streams, device)
    profile_drain(torch, eng, cfg.vocab)
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
        "launches", "prefill_s")}))
    print("[7b] non-spec, same target " + json.dumps({k: bm[k] for k in (
        "wall_s", "tokens", "tokens_per_s", "ttft_p50_ms", "ttft_max_ms",
        "decode_dispatches", "preemptions", "launches")}))
    check_spec_replay(torch, cfg, spec_eng.params, prompts, spec_streams,
                      base, device)
    profile_drain(torch, spec_eng, cfg.vocab, tag="[7b]",
                  kernel="paged_attention_multi")
    print(f"[ ] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
