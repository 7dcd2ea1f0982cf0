"""Slot scheduler for the paged serving engine (host-side bookkeeping).

A copy of ``repro.serve.scheduler``: pure Python and numpy, no tensors. The
device side (``repro_torch.serve.steps`` / ``repro_torch.serve.batch``)
sees a fixed ``max_batch``-wide decode step; this module decides *which
request lives in which slot when*:

* an **admission queue** (FIFO) of submitted requests;
* ``max_batch`` **slots**, each free or owning one in-flight request;
* per-request accounting — generated tokens, EOS, remaining budget — via
  :meth:`Request.add_token`, the host-side mirror of the decode chunk's
  masking rule (a token is recorded iff the slot was still live; EOS or an
  exhausted ``max_new_tokens`` budget finishes the request).

The engine drives it: ``admit(can_admit)`` -> prefill each admission into
its free slot -> decode chunk -> ``record_decode()`` with the emitted token
grid -> repeat until ``has_work()`` is false. The ``can_admit`` gate is the
engine's block check (already-resident shared-prefix blocks count as zero
additional need), and :meth:`preempt` evicts the *youngest* request back to
the queue front when a decode chunk would exhaust the pool. A gated
admission that fails leaves the queue head in place — FIFO order is never
rotated.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # [S] token ids
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    admit_seq: int = -1               # admission order (preemption picks max)
    # wall-clock marks filled in by the engine (benchmark latency accounting)
    submit_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.output)

    def add_token(self, tok: int, eos_id: int | None) -> bool:
        """Record one generated token; returns True when the request is done.

        Mirrors the device-side in-scan masking rule exactly: the token is
        appended only while the request is live, EOS (when configured) is
        appended *then* finishes it, and the ``max_new_tokens`` budget
        finishes it after the last appended token."""
        if self.done:
            return True
        self.output.append(int(tok))
        if eos_id is not None and int(tok) == eos_id:
            self.done = True
        if self.remaining <= 0:
            self.done = True
        return self.done

    def restart(self) -> None:
        """Reset generation state after a preemption.

        The request re-runs from scratch (prefill + greedy decode), which
        regenerates the discarded tokens bit-for-bit — greedy decode is
        deterministic — so preemption never changes a request's stream."""
        self.output.clear()
        self.done = False


class SlotScheduler:
    """Fixed-width slot table + FIFO admission queue."""

    def __init__(self, max_batch: int):
        assert max_batch >= 1
        self.max_batch = max_batch
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.n_admitted = 0
        self.n_finished = 0
        self.n_preempted = 0

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    # -- slots ---------------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def occupied(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def admit(self, can_admit=None) -> list[tuple[int, Request]]:
        """Pop queued requests into free slots (FIFO x lowest slot first).

        ``can_admit(req) -> bool`` gates each admission on external resources
        (the paged engine passes the block pool's free-block check). The head
        is *peeked* before it is popped: a failed admission leaves it at the
        front of the queue — nothing behind it may overtake, and the same
        request is retried first next round. (Pop-then-requeue would rotate a
        temporarily-unadmittable head behind later arrivals and permanently
        break FIFO order.)

        Returns the (slot, request) pairs admitted this round; the caller
        prefills each request and writes its cache into the slot, then calls
        :meth:`release` immediately if the prefill token already finished it
        (prefill-EOS or ``max_new_tokens == 1``)."""
        admitted = []
        free = self.free_slots()
        while free and self.queue:
            req = self.queue[0]
            if can_admit is not None and not can_admit(req):
                break
            self.queue.popleft()
            i = free.pop(0)
            self.slots[i] = req
            req.admit_seq = self.n_admitted
            self.n_admitted += 1
            admitted.append((i, req))
        return admitted

    def release(self, i: int) -> Request:
        req = self.slots[i]
        assert req is not None, f"slot {i} already free"
        self.slots[i] = None
        self.n_finished += 1
        return req

    def preempt(self, i: int) -> Request:
        """Evict slot ``i``'s request back to the FRONT of the queue.

        The paged engine calls this when a decode chunk would exhaust the
        block pool, always picking the *youngest* request (max ``admit_seq``
        over occupied slots) — it has the least work to redo and every
        request older than it is already ahead of the queue, so appendleft
        preserves global FIFO order. The request restarts from scratch on
        re-admission (see :meth:`Request.restart`)."""
        req = self.slots[i]
        assert req is not None, f"slot {i} is free, cannot preempt"
        self.slots[i] = None
        self.n_preempted += 1
        req.restart()
        self.queue.appendleft(req)
        return req

    def youngest(self) -> int | None:
        """Occupied slot holding the most recently admitted request."""
        occ = self.occupied()
        if not occ:
            return None
        return max(occ, key=lambda t: t[1].admit_seq)[0]

    # -- decode accounting ---------------------------------------------------

    def record_decode(self, tokens, emitted, eos_id: int | None) -> list[int]:
        """Fold one fused decode chunk's token grid into the slot requests.

        tokens/emitted: [chunk, max_batch] arrays from the fused decode (the
        per-step next token and whether the slot was live when it was
        produced). Returns the slots whose request finished this chunk; the
        caller releases them (and collects their outputs)."""
        tokens = np.asarray(tokens)
        emitted = np.asarray(emitted)
        finished = []
        for i, req in self.occupied():
            for s in range(tokens.shape[0]):
                if not emitted[s, i]:
                    continue
                if req.add_token(tokens[s, i], eos_id):
                    break
            if req.done:
                finished.append(i)
        return finished
