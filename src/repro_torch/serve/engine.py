"""Serving engine: paged KV over the block-native decode path, slot-based
continuous batching, and the legacy cohort drain.

The counterpart of ``repro.serve.engine.ServeEngine`` for the families the
port runs, with every argument of its constructor.

``mode="paged"``: a :class:`~repro_torch.serve.batch.BlockPool`
owns the physical ``[num_blocks + 1, block_size, L, Hkv, Dh]`` KV pools;
each request holds only the blocks its tokens occupy, mapped through a
per-slot block table. Admission is gated on *free blocks*, not on slot
count; when a decode chunk would exhaust the pool, the youngest request is
preempted back to the queue front and restarts later (greedy decode
regenerates its stream). Prefill writes straight into freshly allocated
blocks. ``kv_impl`` picks the decode's read path:

* ``"kernel"`` appends each token to its slot's tail block and attends
  through the block table with the CUDA paged-attention kernel
  (:func:`repro_torch.kernels.paged_attention`; its plain version for CPU
  tensors, which only a caller that asked for ``device="cpu"`` hands it).
  ``"pallas"`` is the same path: the port's counterpart of the Pallas
  kernel is the CUDA kernel. ``"auto"`` resolves to ``"kernel"`` on every
  device. This departs from the JAX package, whose ``"auto"`` takes the
  reference path off the TPU because its kernel runs only there; the port's
  kernel runs on its own card, and no path falls back from it.
* ``"reference"``, only when asked for, gathers each slot's dense cache
  from the pool, runs the unmodified ``decode_step`` and scatters the
  token's K/V back (:func:`~repro_torch.serve.steps.make_paged_decode`):
  plain PyTorch, the serial computation.

With ``share_prefix=True``
(default) a :class:`~repro_torch.serve.batch.PrefixIndex` aliases common
prompt prefixes to the blocks that already hold them: prefix K/V is written
once, admission counts resident shared blocks as zero additional need, an
exact whole-prompt hit skips prefill, and a shared tail block is forked
(copy-on-write) before any slot's append writes to it.

With ``speculate=SpecConfig(draft_cfg, draft_params, k)`` each decode
chunk runs speculative rounds instead (:mod:`repro_torch.serve.spec`): a
dense draft with its own slot-layout cache, prefilled at every admission,
proposes ``k`` tokens, the target verifies the ``k + 1``-token window
through the block table with the CUDA kernel
:func:`repro_torch.kernels.paged_attention_multi` (its plain version under
``kv_impl="reference"``), and after each chunk the blocks past every slot's
accepted length are trimmed back to the pool. The kernel takes a window of
at most 8 rows, and at most 64 rows over the query heads of one KV head;
the engine refuses a ``SpecConfig`` past that at construction, where the
JAX engine accepts it (``ROADMAP.md``, queue 3).

``mode="continuous"`` (the default, as in the JAX package): a
:class:`~repro_torch.serve.scheduler.SlotScheduler`
owns ``max_batch`` decode slots, each reserving a whole cache of the
model's own layout (:func:`~repro_torch.serve.batch.init_slot_cache`); each
queued request is prefilled on its own (exact prompt length, batch 1) and
its cache written into a free slot mid-decode. Decode runs
``decode_chunk`` tokens per dispatch
(:func:`~repro_torch.serve.steps.make_fused_decode`) with EOS and budget
masking on the device, and one host read per chunk. This is the mode that
serves the hybrid family (``recurrentgemma-2b``), whose prefill runs the
CUDA flash-attention and RG-LRU kernels, and the ssm family
(``rwkv6-1.6b``), whose prefill and decode steps run the CUDA WKV kernel
(:mod:`repro_torch.kernels.ops`); paged mode refuses both, as the JAX
package's does.

``mode="cohort"``: the legacy fixed-cohort drain, kept as it is in the
JAX package, as the baseline that its ``benchmarks/serve_bench.py``
measures the other modes against: ``max_batch`` queued requests at a time,
their prompts left-padded with token 0 into one batch prefill (the pads
are attended, with no mask), then one decode step per token for the whole
cohort; every request's first-token and finish times are the cohort's.
Its streams are the JAX cohort drain's, not serial decode's.

``prefill_bucket=True`` pads admission prefills (continuous, paged and the
speculative draft's) to a power-of-two length on dense full-attention
configs only: right pads are causally masked, so the logits move only by
the order of sums.

A live ``recorder`` (:class:`repro_torch.obs.Recorder`) gets the JAX
engine's metrics under its names: counters, spans and instants at the
chunk boundaries, per-request ``serve_ttft_s``, ``serve_latency_s`` and
``serve_itl_s`` with a ``request_done`` event, boundary gauges and the
drain's ``serve_<stat>`` gauges with a ``drain_done`` event. It is host-side
only, so streams are the same with obs on and off.

``run()`` drains the queue to ``{rid: tokens}``; ``stream()`` yields
``(rid, delta_tokens, done)`` at admission and at every chunk boundary
(paged and continuous modes).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention_multi import MAX_ROWS, MAX_WINDOW
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import compute_params, require_ported
from repro_torch.obs.recorder import NullRecorder
from repro_torch.serve.batch import (BlockPool, PrefixIndex, copy_block,
                                     init_slot_cache, write_prefill,
                                     write_slot)
from repro_torch.serve.scheduler import Request, SlotScheduler
from repro_torch.serve.spec import KV_IMPLS, SpecConfig, make_spec_decode
from repro_torch.serve.steps import (make_decode_step, make_fused_decode,
                                     make_paged_decode,
                                     make_paged_kernel_decode,
                                     make_prefill_step)

PAGED_FAMILIES = ("dense", "vlm", "moe")


def _check_draft(cfg: ModelConfig, dcfg: ModelConfig) -> None:
    """The JAX engine's checks on a speculative draft, with its messages;
    then the port's own limit: the draft runs the dense slot decode."""
    if dcfg.vocab != cfg.vocab:
        raise ValueError("draft vocab must match the target's: "
                         f"{dcfg.vocab} != {cfg.vocab}")
    # every round rewinds the draft by overwriting its cache ``idx``: sound
    # only when all decode-time state is position-indexed KV — recurrent
    # state folds rejected drafts in, and a window ring cache may already
    # have evicted the rewind target
    if dcfg.window is not None or dcfg.family not in (
            "dense", "vlm", "moe", "audio"):
        raise ValueError(
            "speculative draft needs a full-attention KV family "
            "(rewind = idx overwrite); got "
            f"family={dcfg.family!r} window={dcfg.window!r}")
    require_ported(dcfg)


def _check_verify_window(cfg: ModelConfig, k: int) -> None:
    """The CUDA verify kernel's limit, checked where the engine is built
    rather than at the first verify: one thread block owns the window's Q
    rows of every query head of a KV head. The JAX package's kernel has no
    such limit (``ROADMAP.md``, queue 3)."""
    Q, G = k + 1, cfg.n_heads // cfg.n_kv_heads
    if Q > MAX_WINDOW or Q * G > MAX_ROWS:
        raise ValueError(
            f"speculate k={k}: the verify window holds {Q} rows x {G} query "
            f"heads per KV head = {Q * G} rows, and the port's CUDA kernel "
            f"paged_attention_multi takes at most {MAX_WINDOW} rows and "
            f"{MAX_ROWS} rows x heads (ROADMAP.md, queue 3); "
            "kv_impl='reference' verifies through the plain version")


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, capacity: int = 256,
                 max_batch: int = 8, eos_id: int | None = None,
                 mode: str = "continuous", decode_chunk: int = 8,
                 prefill_bucket: bool = False, block_size: int = 16,
                 num_blocks: int | None = None, kv_impl: str = "auto",
                 share_prefix: bool = True,
                 speculate: SpecConfig | None = None, recorder=None,
                 device: str | torch.device = "cuda"):
        if mode not in ("continuous", "cohort", "paged"):
            raise ValueError(
                f"mode must be continuous|cohort|paged, got {mode!r}")
        if speculate is not None and mode != "paged":
            raise ValueError("speculate=SpecConfig(...) requires mode='paged'")
        if mode == "paged":
            if cfg.family not in PAGED_FAMILIES or cfg.window is not None:
                raise ValueError(
                    "paged mode needs a full-attention KV-cache family "
                    f"(one of {PAGED_FAMILIES}, window=None); got "
                    f"family={cfg.family!r} window={cfg.window!r}")
            if kv_impl not in KV_IMPLS:
                raise ValueError(
                    f"kv_impl must be one of {KV_IMPLS}, got {kv_impl!r}")
        require_ported(cfg)
        if speculate is not None:
            _check_draft(cfg, speculate.draft_cfg)
            if kv_impl != "reference":
                _check_verify_window(cfg, speculate.k)
        self.device = resolve_device(device)
        # host-side only: the recorder sees counters, spans and request
        # times at the chunk boundaries the loop already crosses and never
        # touches the device computation, so streams are the same with obs
        # on or off
        self.recorder = NullRecorder() if recorder is None else recorder
        self.cfg = cfg
        self.params = compute_params(cfg, params, self.device)
        self.capacity, self.max_batch = capacity, max_batch
        self.eos_id, self.mode, self.decode_chunk = eos_id, mode, decode_chunk
        self.block_size = block_size
        # pad admission prefills to power-of-two lengths. Right pads are
        # causally masked, so this is exact up to the order of sums (not
        # bitwise). Recurrent state and ring caches would absorb the pads,
        # so only dense full-attention configs bucket (a speculative draft
        # is one: ``_check_draft``).
        self._bucket = (prefill_bucket and cfg.family == "dense"
                        and cfg.window is None)
        self.scheduler = SlotScheduler(max_batch)
        self._prefill = make_prefill_step(cfg, capacity)
        self._decode = make_decode_step(cfg)   # the cohort drain's step
        self.pool: BlockPool | None = None
        self.kv_impl: str | None = None   # the paged read path
        self.prefix: PrefixIndex | None = None
        self.spec = speculate
        self._dcache = None  # the draft's slot cache, made per drain
        self._next_rid = 0
        self._streamed: dict[int, int] = {}
        self.stats: dict = {}
        self.completed: dict[int, Request] = {}
        if mode == "continuous":
            self._fused_decode = make_fused_decode(cfg, decode_chunk, eos_id)
        if mode != "paged":
            return
        self.kv_impl = "kernel" if kv_impl == "auto" else kv_impl
        if num_blocks is None:
            # the KV memory a dense engine of this max_batch/capacity would
            # reserve up front
            num_blocks = max_batch * capacity // block_size
        self.pool = BlockPool(cfg, num_blocks=num_blocks,
                              block_size=block_size, max_batch=max_batch,
                              capacity=capacity, device=self.device)
        make_step = (make_paged_decode if self.kv_impl == "reference"
                     else make_paged_kernel_decode)
        self._paged_decode = make_step(cfg, block_size, decode_chunk, eos_id)
        # positions one dispatch can advance a slot: decode_chunk serially,
        # or rounds x (k + 1) verify rows under speculation. Emitted rows
        # only ever read positions below idx + adv, so this is also the
        # pre-chunk ensure horizon; window writes past it go to trash.
        self._adv = decode_chunk
        if speculate is not None:
            dcfg = speculate.draft_cfg
            rounds = speculate.rounds_for(decode_chunk)
            self._adv = rounds * (speculate.k + 1)
            self._draft_params = compute_params(dcfg, speculate.draft_params,
                                                self.device)
            self._draft_prefill = make_prefill_step(dcfg, capacity)
            self._spec_decode = make_spec_decode(
                cfg, dcfg, block_size, speculate.k, rounds, eos_id,
                impl=self.kv_impl)
        self.prefix = PrefixIndex(self.pool.alloc) if share_prefix else None

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + max_new_tokens
        if self.mode == "paged" and (
                total > self.capacity
                or self.pool.blocks_for(total) > self.pool.num_blocks):
            self.recorder.counter_add("serve_submit_rejects")
            raise ValueError(
                f"request needs {total} cache positions "
                f"({self.pool.blocks_for(total)} blocks); pool holds "
                f"{self.pool.num_blocks} blocks of {self.block_size} "
                f"with per-request capacity {self.capacity}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      submit_s=time.perf_counter())
        self.scheduler.submit(req)
        self.recorder.counter_add("serve_submitted")
        self.recorder.instant("submit", rid=rid, prompt_len=len(prompt),
                              budget=max_new_tokens)
        return rid

    def _record_done(self, req: Request) -> None:
        """Per-request latency accounting at completion: TTFT, end-to-end
        latency, mean inter-token gap, and a ``request_done`` event keyed by
        rid."""
        rec = self.recorder
        if not rec.enabled:
            return
        ttft = (req.first_token_s - req.submit_s) if req.first_token_s else 0.0
        latency = (req.finish_s - req.submit_s) if req.finish_s else 0.0
        rec.counter_add("serve_finished")
        rec.observe("serve_ttft_s", ttft)
        rec.observe("serve_latency_s", latency)
        if req.first_token_s and req.finish_s and len(req.output) > 1:
            rec.observe("serve_itl_s", (req.finish_s - req.first_token_s)
                        / (len(req.output) - 1))
        rec.event("request_done", rid=req.rid, ttft_s=ttft,
                  latency_s=latency, tokens=len(req.output))

    def _boundary_gauges(self, stats: dict) -> None:
        """Chunk-boundary gauges: queue depth, concurrency, pool occupancy."""
        rec = self.recorder
        if not rec.enabled:
            return
        rec.gauge_set("serve_queue_depth", len(self.scheduler.queue))
        rec.gauge_set("serve_concurrency", len(self.scheduler.occupied()))
        if self.pool is not None:
            rec.gauge_set("serve_free_blocks", self.pool.free_blocks)
            rec.gauge_set("serve_block_occupancy",
                          1.0 - self.pool.free_blocks / self.pool.num_blocks)

    def _export_stats(self, stats: dict, elapsed_s: float) -> None:
        """Mirror the drain's stats into the recorder (``serve_`` prefix),
        with the realised tokens/s of the whole drain."""
        rec = self.recorder
        if not rec.enabled:
            return
        for k, v in stats.items():
            rec.gauge_set(f"serve_{k}", v)
        tps = stats.get("emitted_tokens", 0) / max(elapsed_s, 1e-9)
        rec.gauge_set("serve_tokens_per_sec", tps)
        rec.event("drain_done", elapsed_s=elapsed_s, tokens_per_sec=tps,
                  **stats)
        rec.flush()

    # -- shared helpers ------------------------------------------------------

    def _admission_batch(self, req: Request) -> dict:
        """Prefill inputs for one admitted request: exact length, or
        right-padded to a power-of-two bucket (at least 8, at most
        ``capacity``) with its true ``length`` when ``prefill_bucket`` is
        on. Shared by the continuous and paged prefills and the speculative
        draft's."""
        L = len(req.prompt)
        toks, length = req.prompt, None
        if self._bucket:
            pad_to = min(max(8, 1 << max(L - 1, 1).bit_length()),
                         self.capacity)
            if L < pad_to:
                toks = np.zeros(pad_to, np.int32)
                toks[:L] = req.prompt
                length = L
        batch = {"tokens": torch.as_tensor(toks[None], device=self.device)}
        if length is not None:
            batch["length"] = length
        return batch

    def _emit(self, reqs):
        """Yield the not-yet-streamed suffix of each request's output.

        After a preemption the request regenerates its tokens from scratch;
        the per-rid high-water mark suppresses re-yields until the
        regeneration passes what was already streamed."""
        for req in reqs:
            n = self._streamed.get(req.rid, 0)
            delta = req.output[n:]
            if delta:
                self._streamed[req.rid] = n + len(delta)
                yield req.rid, list(delta), req.done

    def _prefill_first_token(self, req: Request):
        """Run the admission prefill; returns (first_token, request
        cache)."""
        with self.recorder.span("prefill", rid=req.rid,
                                prompt_len=len(req.prompt)):
            logits, req_cache = self._prefill(self.params,
                                              self._admission_batch(req))
            first = int(torch.argmax(logits[0, -1]))
        if not req.first_token_s:
            req.first_token_s = time.perf_counter()
        return first, req_cache

    def _evict_in_flight(self) -> None:
        """Return in-flight requests to the queue front (youngest first, so
        FIFO order is preserved) and release their blocks. A consumer that
        abandons ``stream()`` mid-drain must not strand slots or leak KV
        blocks: the next ``run()``/``stream()`` call re-admits the evicted
        requests."""
        sched = self.scheduler
        for i, _ in sorted(sched.occupied(), key=lambda t: -t[1].admit_seq):
            if self.pool is not None:
                self.pool.release(i)
            sched.preempt(i)

    # -- continuous batching -------------------------------------------------

    def _stream_continuous(self):
        sched, B = self.scheduler, self.max_batch
        cache = init_slot_cache(self.cfg, B, self.capacity,
                                device=self.device)
        tok = np.zeros((B,), np.int32)
        live = np.zeros((B,), bool)
        remaining = np.zeros((B,), np.int32)
        stats = {"prefills": 0, "decode_dispatches": 0, "decode_steps": 0,
                 "emitted_tokens": 0, "peak_concurrency": 0}

        def finish(i: int) -> Request:
            req = sched.release(i)
            req.finish_s = time.perf_counter()
            live[i] = False
            remaining[i] = 0
            self.completed[req.rid] = req
            self._record_done(req)
            return req

        t0 = time.perf_counter()
        try:
            yield from self._continuous_loop(cache, tok, live, remaining,
                                             stats, finish)
        finally:
            self.stats = stats
            self._export_stats(stats, time.perf_counter() - t0)
            self._evict_in_flight()

    def _continuous_loop(self, cache, tok, live, remaining, stats, finish):
        sched, dev = self.scheduler, self.device
        while sched.has_work():
            # admission: prefill queued requests into free slots, mid-decode
            for i, req in sched.admit():
                first, req_cache = self._prefill_first_token(req)
                stats["prefills"] += 1
                stats["emitted_tokens"] += 1   # the prefill-produced token
                if req.add_token(first, self.eos_id):
                    finish(i)   # prefill token was EOS or budget == 1
                else:
                    write_slot(cache, req_cache, i)
                    tok[i], live[i] = first, True
                    remaining[i] = req.remaining
                yield from self._emit([req])
            stats["peak_concurrency"] = max(stats["peak_concurrency"],
                                            len(sched.occupied()))
            self._boundary_gauges(stats)
            if not live.any():
                continue   # the queue may still hold work
            with self.recorder.span("decode_chunk", steps=self.decode_chunk):
                tok_d, cache, live_d, remaining_d, tokens, emitted = \
                    self._fused_decode(
                        self.params, torch.as_tensor(tok, device=dev), cache,
                        torch.as_tensor(live, device=dev),
                        torch.as_tensor(remaining, device=dev))
                # one host read per chunk: the chunk's tokens, emit masks
                # and the slots' carried state, packed into one int32 array
                c = tokens.shape[0]
                host = torch.cat([
                    tokens, emitted.to(torch.int32),
                    torch.stack([tok_d, live_d.to(torch.int32),
                                 remaining_d])]).cpu().numpy()
            # in place: finish() closes over these same arrays
            tok[:], live[:], remaining[:] = host[2 * c:]
            tokens, emitted = host[:c], host[c:2 * c].astype(bool)
            stats["decode_dispatches"] += 1
            stats["decode_steps"] += self.decode_chunk
            stats["emitted_tokens"] += int(emitted.sum())
            reqs = [r for _, r in sched.occupied()]
            for i in sched.record_decode(tokens, emitted, self.eos_id):
                finish(i)
            yield from self._emit(reqs)

    # -- paged KV ------------------------------------------------------------

    def _stream_paged(self):
        sched, pool = self.scheduler, self.pool
        B = self.max_batch
        tok = np.zeros((B,), np.int32)
        idx = np.zeros((B,), np.int32)
        live = np.zeros((B,), bool)
        remaining = np.zeros((B,), np.int32)
        stats = {"prefills": 0, "decode_dispatches": 0, "decode_steps": 0,
                 "emitted_tokens": 0, "preemptions": 0, "peak_concurrency": 0,
                 "prefix_hits": 0, "cow_forks": 0, "prefill_tokens": 0,
                 "prefill_s": 0.0, "peak_blocks_in_use": 0,
                 "peak_shared_blocks": 0}
        if self.spec is not None:
            # spec_rounds: slot-rounds that proposed (live at the round's
            # start); spec_full_rounds: those that accepted all k drafts
            stats.update(spec_proposed=0, spec_accepted=0, draft_prefills=0,
                         spec_rounds=0, spec_full_rounds=0)
            self._dcache = init_slot_cache(self.spec.draft_cfg, B,
                                           self.capacity, device=self.device)

        def finish(i: int) -> Request:
            req = sched.release(i)
            pool.release(i)
            req.finish_s = time.perf_counter()
            live[i] = False
            remaining[i] = 0
            self.completed[req.rid] = req
            self._record_done(req)
            return req

        def preempt(i: int) -> None:
            pool.release(i)
            req = sched.preempt(i)
            live[i] = False
            remaining[i] = 0
            stats["preemptions"] += 1
            self.recorder.counter_add("serve_preemptions")
            self.recorder.instant("preempt", rid=req.rid,
                                  regenerated=len(req.output))

        t0 = time.perf_counter()
        try:
            yield from self._paged_loop(tok, idx, live, remaining, stats,
                                        finish, preempt)
        finally:
            self.stats = stats
            self._export_stats(stats, time.perf_counter() - t0)
            self._evict_in_flight()

    def _admission_need(self, req: Request) -> int:
        """Free-list headroom admitting ``req`` costs right now: fresh pages
        its prompt (+1 token) needs beyond the cached-prefix match, plus one
        free-list pop per matched block that must be *revived* (refcount 0 —
        resident shared blocks cost zero additional need), plus one block of
        copy-on-write headroom when an exact match shares a partial tail
        block (the first decode append forks it)."""
        pool = self.pool
        pages = pool.blocks_for(len(req.prompt) + 1)
        m = self.prefix.match(req.prompt) if self.prefix is not None else None
        if m is None:
            return pages
        resident = sum(1 for b in m.blocks if pool.refcount(b) > 0)
        need = pages - resident
        if m.exact and len(req.prompt) % self.block_size:
            need += 1
        return need

    def _admit(self, stats, finish, preempt, tok, idx, live, remaining):
        """One admission round: prefill (or prefix-attach) queued requests
        into free slots while the pool has room. Yields stream deltas."""
        sched, pool, prefix = self.scheduler, self.pool, self.prefix
        # ``claimed`` front-runs the attach/ensure calls below so one round
        # admitting several requests cannot oversubscribe the free list
        claimed = [0]

        def can_admit(r) -> bool:
            need = self._admission_need(r)
            if claimed[0] + need > pool.free_blocks:
                self.recorder.counter_add("serve_admission_rejects")
                return False
            claimed[0] += need
            return True

        for i, req in sched.admit(can_admit):
            # re-match at attach time: an earlier admission this round may
            # have reused a freed-but-cached block the can_admit match
            # counted on (its generation bump invalidates it)
            m = prefix.match(req.prompt) if prefix is not None else None
            if m is not None and m.exact:
                # every page (incl. the partial tail) and the greedy first
                # token are cached: skip prefill and alias the blocks below
                first, req_cache = m.first_tok, None
                stats["prefix_hits"] += 1
                if not req.first_token_s:
                    req.first_token_s = time.perf_counter()
                self.recorder.counter_add("serve_prefix_hits")
                self.recorder.instant("prefix_hit", rid=req.rid,
                                      cached_tokens=m.n_tokens)
            else:
                t_pf = time.perf_counter()
                first, req_cache = self._prefill_first_token(req)
                stats["prefills"] += 1
                stats["prefill_s"] += time.perf_counter() - t_pf
                stats["prefill_tokens"] += len(req.prompt)
            stats["emitted_tokens"] += 1
            if req.add_token(first, self.eos_id):
                finish(i)   # prefill token was EOS or budget == 1
                yield from self._emit([req])
                continue
            if m is not None:
                pool.attach(i, m.blocks)
            if not pool.ensure(i, len(req.prompt)):
                # the can_admit claim was computed against a larger match
                # than survived to attach time: hand the request back to
                # the queue front; it re-admits next round
                preempt(i)
                continue
            if m is None or not m.exact:
                # write once: matched pages stay untouched (they already
                # hold this prompt's prefix K/V and may be shared with live
                # readers) — route them to trash, scatter only the tail
                tbl = pool.tables[i].copy()
                if m is not None:
                    tbl[:len(m.blocks)] = pool.trash
                write_prefill(pool.data, req_cache, tbl,
                              block_size=self.block_size)
                if prefix is not None:
                    prefix.record(req.prompt,
                                  pool.tables[i, :pool.owned(i)], first)
            tok[i], idx[i] = first, len(req.prompt)
            live[i], remaining[i] = True, req.remaining
            if self.spec is not None:
                # draft prefill runs even on exact prefix hits: the draft's
                # dense cache has no prefix index to alias from, and a
                # preemption restart rebuilds it the same way
                with self.recorder.span("draft_prefill", rid=req.rid,
                                        prompt_len=len(req.prompt)):
                    _, d_cache = self._draft_prefill(
                        self._draft_params,
                        self._admission_batch(req))
                    write_slot(self._dcache, d_cache, i)
                stats["draft_prefills"] += 1
            yield from self._emit([req])

    def _ensure_chunk_blocks(self, stats, preempt, idx, live, remaining):
        """Pre-chunk block budget, oldest first: every live slot makes its
        tail page exclusive (copy-on-write fork — shared blocks are
        read-only, and the append writes through ``tables[i, idx //
        block_size]``) and covers its chunk's writes. If the pool runs dry,
        the youngest request is evicted — it has the least work to redo and
        re-queues at the front, keeping FIFO."""
        sched, pool = self.scheduler, self.pool
        for i, _ in sorted(sched.occupied(), key=lambda t: t[1].admit_seq):
            if not live[i]:
                continue
            page = int(idx[i]) // self.block_size
            while pool.needs_fork(i, page):
                if pool.free_blocks:
                    old, new = pool.fork_for_write(i, page)
                    copy_block(pool.data, old, new)
                    stats["cow_forks"] += 1
                    self.recorder.counter_add("serve_cow_forks")
                    break
                preempt(sched.youngest())   # may drop the shared ref
            if not live[i]:
                continue   # preempted itself while hunting fork room
            need = int(idx[i]) + min(self._adv, int(remaining[i]))
            while not pool.ensure(i, need):
                victim = sched.youngest()
                if victim == i and len(sched.occupied()) == 1:
                    # unreachable: submit() caps a lone request's total
                    # need at the pool size
                    raise RuntimeError("block pool exhausted by a single "
                                       "request")
                preempt(victim)
                if victim == i:
                    break

    def _paged_loop(self, tok, idx, live, remaining, stats, finish, preempt):
        sched, pool, dev = self.scheduler, self.pool, self.device
        while sched.has_work():
            yield from self._admit(stats, finish, preempt, tok, idx, live,
                                   remaining)
            stats["peak_concurrency"] = max(stats["peak_concurrency"],
                                            len(sched.occupied()))
            stats["peak_blocks_in_use"] = max(
                stats["peak_blocks_in_use"],
                pool.num_blocks - pool.free_blocks)
            if not live.any():
                continue
            self._ensure_chunk_blocks(stats, preempt, idx, live, remaining)
            stats["peak_shared_blocks"] = max(stats["peak_shared_blocks"],
                                              pool.shared_blocks())
            self._boundary_gauges(stats)
            if not live.any():
                continue
            # length clamp: hand the device only the first `hw` table
            # columns (every live slot's blocks sit below the allocator's
            # high-water mark), bucketed to the next power of two as the
            # JAX engine buckets it
            hw = min(1 << max(pool.high_water() - 1, 0).bit_length(),
                     pool.max_blocks)
            with self.recorder.span("decode_chunk", steps=self._adv):
                args = (torch.as_tensor(tok, device=dev), pool.data,
                        torch.as_tensor(pool.tables[:, :hw].copy(),
                                        device=dev),
                        torch.as_tensor(idx, device=dev),
                        torch.as_tensor(live, device=dev),
                        torch.as_tensor(remaining, device=dev))
                if self.spec is None:
                    (tok_d, pool.data, idx_d, live_d, remaining_d, tokens,
                     emitted) = self._paged_decode(self.params, *args)
                    counts = []
                else:
                    (tok_d, pool.data, idx_d, live_d, remaining_d, tokens,
                     emitted, self._dcache, proposed,
                     accepted) = self._spec_decode(
                        self.params, self._draft_params, *args,
                        self._dcache)
                    counts = [proposed, accepted]
                # one host read per chunk: the chunk's tokens, emit masks,
                # the slots' carried state and the draft counts, packed
                # into one int32 array
                c = tokens.shape[0]
                host = torch.cat([
                    tokens, emitted.to(torch.int32),
                    torch.stack([tok_d, idx_d, live_d.to(torch.int32),
                                 remaining_d]), *counts]).cpu().numpy()
                tokens, emitted = host[:c], host[c:2 * c].astype(bool)
            # in place: finish()/preempt() close over these same arrays
            tok[:], idx[:], live[:], remaining[:] = host[2 * c:2 * c + 4]
            if self.spec is not None:
                proposed, accepted = np.split(host[2 * c + 4:], 2)
                n_p, n_a = int(proposed.sum()), int(accepted.sum())
                stats["spec_proposed"] += n_p
                stats["spec_accepted"] += n_a
                stats["spec_rounds"] += int((proposed > 0).sum())
                stats["spec_full_rounds"] += int(
                    ((proposed > 0) & (accepted == proposed)).sum())
                self.recorder.counter_add("serve_spec_proposed", n_p)
                self.recorder.counter_add("serve_spec_accepted", n_a)
            stats["decode_dispatches"] += 1
            stats["decode_steps"] += self._adv
            stats["emitted_tokens"] += int(emitted.sum())
            reqs = [r for _, r in sched.occupied()]
            for i in sched.record_decode(tokens, emitted, self.eos_id):
                finish(i)
            if self.spec is not None:
                # speculative rewind: return the ensure headroom the verify
                # did not fill (rejected-window tail blocks), so a partial
                # acceptance never strands pool pages across chunks
                for i, _ in sched.occupied():
                    pool.trim(i, int(idx[i]))
            yield from self._emit(reqs)

    # -- cohort drain (legacy baseline) --------------------------------------

    def _pad_batch(self, reqs: list[Request]):
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt   # left-pad
        return torch.as_tensor(toks, device=self.device)

    def _run_cohort(self) -> dict[int, list[int]]:
        results: dict[int, list[int]] = {}
        sched = self.scheduler
        stats = {"prefills": 0, "decode_dispatches": 0, "decode_steps": 0,
                 "emitted_tokens": 0, "peak_concurrency": 0}
        t0 = time.perf_counter()
        while sched.queue:
            reqs = [sched.queue.popleft()
                    for _ in range(min(self.max_batch, len(sched.queue)))]
            sched.n_admitted += len(reqs)   # cohorts bypass the slot table
            stats["peak_concurrency"] = max(stats["peak_concurrency"],
                                            len(reqs))
            logits, cache = self._prefill(self.params,
                                          {"tokens": self._pad_batch(reqs)})
            stats["prefills"] += 1
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            now = time.perf_counter()
            for r, t in zip(reqs, tok[:, 0].tolist()):
                r.first_token_s = now
                r.add_token(t, self.eos_id)
                stats["emitted_tokens"] += 1
            steps = max(r.max_new_tokens for r in reqs) - 1
            for _ in range(max(steps, 0)):
                if all(r.done for r in reqs):
                    break   # every request finished: no more decode steps
                tok, _, cache = self._decode(self.params, tok, cache)
                stats["decode_dispatches"] += 1
                stats["decode_steps"] += 1
                host = tok[:, 0].tolist()
                for i, r in enumerate(reqs):
                    if not r.done:
                        r.add_token(host[i], self.eos_id)
                        stats["emitted_tokens"] += 1
            now = time.perf_counter()
            for r in reqs:
                r.finish_s = now
                results[r.rid] = r.output
                self.completed[r.rid] = r
                self._record_done(r)
            sched.n_finished += len(reqs)
        self.stats = stats
        self._export_stats(stats, time.perf_counter() - t0)
        return results

    # -- entry points --------------------------------------------------------

    def stream(self):
        """Generator over ``(rid, delta_tokens, done)`` events.

        Deltas arrive at admission (the prefill-produced first token) and at
        every ``decode_chunk`` boundary; each request's concatenated deltas
        are exactly its ``run()`` output, and ``done=True`` rides on its
        final delta. Preempted requests never re-yield tokens that were
        already streamed. Abandoning the generator mid-drain evicts the
        in-flight requests back to the queue; a later ``run()``/``stream()``
        resumes where it stopped. The cohort drain has no chunk boundaries
        to stream at."""
        if self.mode == "cohort":
            raise ValueError("stream() requires mode='continuous'|'paged'")
        if self.mode == "continuous":
            yield from self._stream_continuous()
        else:
            yield from self._stream_paged()

    def run(self) -> dict[int, list[int]]:
        """Drain the queue; returns {rid: generated tokens}."""
        if self.mode == "cohort":
            return self._run_cohort()
        results: dict[int, list[int]] = {}
        for rid, delta, _done in self.stream():
            results.setdefault(rid, []).extend(delta)
        return results
