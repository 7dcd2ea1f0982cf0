"""KV-cache block layer of the paged serving engine.

A :class:`BlockPool` owns ONE physical ``[num_blocks + 1, block_size, L,
Hkv, Dh]`` tensor each for K and V (the ``+ 1`` is a trash block that
absorbs masked writes from dead slots, so the decode step never branches).
Each slot holds a ``[max_blocks]`` int32 *block table* mapping logical pages
to physical blocks, so a request only ever occupies ``ceil(tokens /
block_size)`` blocks.

The device-side ops (:func:`write_prefill`, :func:`tail_targets`,
:func:`tail_targets_multi`, :func:`scatter_tokens` — defined beside the
verify step in :mod:`repro_torch.models.paged` —, :func:`copy_block`, and
the ``kv_impl="reference"`` read path's :func:`gather_pages`,
:func:`slice_token` and :func:`scatter_token`) are PyTorch and write the
pool in place where the JAX package returns a new one. The continuous
mode and the speculative draft keep a dense *slot layout* instead
(:func:`init_slot_cache`, :func:`write_slot`, :func:`gather_slot`): every
slot reserves a whole cache of the model's own tree (k/v ``[L, max_batch,
capacity, Hkv, Dh]``, and the audio family's ``cross`` k/v; the hybrid
family's ``blocks``/``rem`` of rings and recurrent state; the ssm family's
``state`` of token shifts and WKV state matrices) with a per-slot ``idx``
vector. The block *allocator* (:class:`BlockAllocator`) and the
shared-prefix index (:class:`PrefixIndex`) are host-side numpy, copied from
``repro.serve.batch``: refcounted blocks let requests that share a prompt
prefix alias the same physical block from several slots' tables, and
:meth:`BlockAllocator.fork_for_write` forks a shared tail block into a fresh
exclusive one before any slot appends to it.

Every leaf's slot axis is found as the JAX package finds it
(:func:`slot_axes`, from :func:`repro_torch.models.cache_batch_axes`).
:class:`BlockPool` checks with the capacity axes as well that every
per-token leaf has a (batch, capacity) axis pair, which leaves the
attention-KV layout ``{"kv": {"k", "v"}}`` of the dense, vlm and moe
families; the device ops here are written for that layout.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.models.config import ModelConfig
# scatter_tokens lives beside the verify step that writes with it; the JAX
# package keeps it here
from repro_torch.models.paged import scatter_tokens  # noqa: F401
from repro_torch.models.transformer import (cache_batch_axes,
                                            cache_capacity_axes, init_cache)


def write_prefill(pool_data, request_cache, table, *, block_size: int):
    """Scatter a batch-1 prefilled request cache into its allocated blocks,
    in place.

    ``request_cache["kv"]`` leaves are ``[L, 1, capacity, Hkv, Dh]``;
    ``table``: the slot's full ``[max_blocks]`` block table (unallocated
    entries point at the trash block, so every page has a destination and
    pad pages land in trash)."""
    t = torch.as_tensor(table, device=pool_data["kv"]["k"].device).long()
    for name in ("k", "v"):
        leaf = request_cache["kv"][name][:, 0]            # [L, cap, Hkv, Dh]
        x = leaf.movedim(1, 0)                            # [cap, L, Hkv, Dh]
        pages = x.reshape(x.shape[0] // block_size, block_size, *x.shape[1:])
        pool = pool_data["kv"][name]
        pool[t] = pages.to(pool.dtype)
    return pool_data


def gather_pages(pool_data, table):
    """One slot's logical dense cache, batch-1 layout without ``idx``
    (``{"kv": {"k", "v"}}`` leaves ``[L, 1, n_pages * block_size, Hkv,
    Dh]``), gathered from the pool through its ``[n_pages]`` block table: a
    copy. Pages mapped to trash carry garbage, which the decode's
    ``kv_len`` rule masks out of every read."""
    t = torch.as_tensor(table, device=pool_data["kv"]["k"].device).long()

    def one(pool):
        pages = pool[t]                            # [n_pages, bs, L, Hkv, Dh]
        x = pages.reshape(-1, *pages.shape[2:])    # [S, L, Hkv, Dh]
        return x.movedim(0, 1)[:, None]            # [L, 1, S, Hkv, Dh]

    return {"kv": {name: one(pool) for name, pool in pool_data["kv"].items()}}


def slice_token(cache, pos):
    """The K/V written at position ``pos`` of a batch-1 dense cache: leaves
    ``[L, Hkv, Dh]``, what :func:`scatter_token` appends to the slot's tail
    block. ``pos`` is clamped into the cache, as the JAX package's
    ``dynamic_slice`` clamps it (a dead slot's position runs past it)."""
    def one(leaf):
        p = torch.as_tensor(pos, device=leaf.device).long().reshape(1)
        return leaf[:, 0].index_select(1, p.clamp(0, leaf.shape[2] - 1))[:, 0]

    return {"kv": {name: one(leaf) for name, leaf in cache["kv"].items()}}


def scatter_token(pool_data, writes, blk, off):
    """Write one token's K/V for every slot at ``(blk[i], off[i])``, in
    place. ``writes`` leaves are ``[B, L, Hkv, Dh]``; ``blk`` is already
    routed to the trash block for dead slots, so distinct live slots always
    target distinct blocks."""
    blk, off = blk.long(), off.long()
    for name, pool in pool_data["kv"].items():
        pool[blk, off] = writes["kv"][name].to(pool.dtype)
    return pool_data


def tail_targets(tables, idx, live, block_size: int, trash: int):
    """Per-slot tail-block write coordinates for the token at position
    ``idx``: ``(blk [B], off [B])`` with dead slots routed to the trash block
    (so a finished slot's ``idx``, which keeps advancing inside a decode
    chunk, can never clobber a live block)."""
    B, max_blocks = tables.shape
    page = torch.clamp(idx // block_size, 0, max_blocks - 1).long()
    rows = torch.arange(B, device=tables.device)
    blk = torch.where(live, tables[rows, page],
                      torch.full_like(tables[:, 0], trash))
    return blk, idx % block_size


def tail_targets_multi(tables, idx, live, q: int, block_size: int,
                       trash: int):
    """Write coordinates for a window of ``q`` tokens at positions
    ``idx .. idx + q - 1`` per slot: ``(blk [B, q], off [B, q])``.

    The window may span a block boundary: each position resolves its own
    page. Dead slots and positions whose page the table does not cover
    (speculative overshoot past the ensured or clamped width, or past
    capacity) go to the trash block; unallocated in-range pages land there
    too, because table padding points at it. ``q = 1`` is
    :func:`tail_targets`."""
    B, max_blocks = tables.shape
    pos = idx[:, None] + torch.arange(q, device=tables.device,
                                      dtype=idx.dtype)           # [B, q]
    page = (pos // block_size).long()
    ok = live[:, None] & (page < max_blocks)
    gathered = torch.gather(tables, 1, torch.clamp(page, 0, max_blocks - 1))
    return torch.where(ok, gathered, torch.full_like(gathered, trash)), \
        pos % block_size


def copy_block(pool_data, src: int, dst: int):
    """Copy-on-write fork, device side: duplicate physical block ``src`` into
    ``dst`` on K and V, in place. The engine calls this right after
    :meth:`BlockAllocator.fork_for_write` repoints a slot's table at the
    fresh block, so the forking slot sees bit-identical content and the
    remaining holders keep reading the untouched original."""
    for pool in pool_data["kv"].values():
        pool[dst].copy_(pool[src])
    return pool_data


def slot_axes(cfg: ModelConfig, capacity: int, *, params=None,
              src_len: int | None = None):
    """Slot-axis tree of the slot layout:
    :func:`repro_torch.models.cache_batch_axes` with the per-slot ``idx``
    vector on axis 0 instead of the batch-invariant ``-1``. The audio
    family needs ``params`` (its cache runs the encoder)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return max(t, 0)

    return walk(cache_batch_axes(cfg, capacity, params=params,
                                 src_len=src_len))


def _map_slots(fn, slot_cache, axes, *others):
    """``fn(leaf, slot_axis, *other leaves)`` over every per-slot leaf of
    ``slot_cache`` (all but ``idx``), with the matching leaves of ``axes``
    and ``others``; returns the results in the same tree."""
    def walk(leaf, axis, *rest):
        if isinstance(leaf, dict):
            return {k: walk(v, axis[k], *(r[k] for r in rest))
                    for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [walk(*vs) for vs in zip(leaf, axis, *rest)]
        return fn(leaf, axis, *rest)

    return {name: walk(leaf, axes[name], *(o[name] for o in others))
            for name, leaf in slot_cache.items() if name != "idx"}


def init_slot_cache(cfg: ModelConfig, max_batch: int, capacity: int, *,
                    device, params=None, src_embeds=None):
    """Empty slot-layout cache: :func:`repro_torch.models.init_cache` for
    ``max_batch`` streams (k/v ``[L, max_batch, capacity, Hkv, Dh]``, and
    for audio the ``cross`` k/v of ``src_embeds`` [max_batch, src_len, D]
    through ``params``' encoder; hybrid: the ``blocks``/``rem`` tree; ssm:
    the ``state`` tree), with ``idx`` a per-slot ``[max_batch]`` int32
    vector."""
    cache = init_cache(cfg, max_batch, capacity, device=device,
                       src_embeds=src_embeds, params=params)
    cache["idx"] = torch.zeros((max_batch,), dtype=torch.int32,
                               device=device)
    return cache


def write_slot(slot_cache, request_cache, i: int, axes):
    """Insert a batch-1 prefilled cache (scalar ``idx``) into slot ``i`` of
    the slot-layout cache, in place: every per-slot leaf's slot row (along
    its axis in ``axes``, :func:`slot_axes`) is overwritten, so nothing of
    the slot's previous request survives."""
    _map_slots(lambda big, ax, small: big.select(ax, i).copy_(
        small.select(ax, 0)), slot_cache, axes, request_cache)
    slot_cache["idx"][i] = int(request_cache["idx"])
    return slot_cache


def gather_slot(slot_cache, i: int, axes):
    """Slot ``i`` of a slot-layout cache as a batch-1 request cache (a copy,
    with a scalar ``idx``)."""
    return {**_map_slots(lambda big, ax: big.narrow(ax, i, 1).clone(),
                         slot_cache, axes),
            "idx": int(slot_cache["idx"][i])}


class BlockAllocator:
    """Pure host-side paged-KV block allocator: free list + refcounts +
    per-slot block tables. No device state. A copy of the JAX package's
    allocator (which ``repro.analysis.contracts`` model-checks); the tests
    hold the two to identical traces.

    Blocks are refcounted so shared-prefix requests can alias one physical
    block from several slots' tables:

    * :meth:`ensure` allocates fresh exclusive blocks (refcount 1);
    * :meth:`attach` appends already-indexed blocks to a slot's table,
      bumping refcounts — a block whose refcount already dropped to 0 is
      *revived* off the free list with content and generation intact;
    * a block with refcount > 1 is read-only: :meth:`fork_for_write` pops a
      fresh block for the writing slot and drops the shared one's refcount
      (the caller mirrors the fork on device with :func:`copy_block`);
    * :meth:`release` decrements once per table occurrence and appends a
      block to the free-list *tail* only at refcount 0 — FIFO reuse keeps
      freed blocks revivable for as long as possible, and the per-block
      allocation ``generation`` (bumped whenever a block is popped off the
      free list) lets :class:`PrefixIndex` invalidate stale entries lazily,
      with no callbacks.

    Invariants after every public op (the checkable spec):

    1. conservation — ``free_blocks + #{blocks with refcount > 0}
       == num_blocks``;
    2. ref-agreement — every block's refcount equals its number of
       occurrences across all live table prefixes
       ``tables[slot, :owned(slot)]``;
    3. trash padding — ``tables[slot, owned(slot):]`` all point at the
       trash block;
    4. free-list exactness — the free list holds exactly the refcount-0
       blocks, each once;
    5. a failed ``ensure`` / ``fork_for_write`` (refused for lack of free
       blocks, allocating nothing) changes nothing.
    """

    def __init__(self, *, num_blocks: int, block_size: int, max_batch: int,
                 capacity: int):
        if capacity % block_size:
            raise ValueError(f"capacity {capacity} must be a multiple of "
                             f"block_size {block_size}")
        self.num_blocks, self.block_size = num_blocks, block_size
        self.max_batch, self.capacity = max_batch, capacity
        self.max_blocks = capacity // block_size
        self.trash = num_blocks
        self.tables = np.full((max_batch, self.max_blocks), self.trash,
                              np.int32)
        # FIFO: allocate from the front, free to the back — a freed block
        # stays revivable (content intact) until every earlier-freed block
        # has been reused first
        self._free: list[int] = list(range(num_blocks))
        self._refs = np.zeros(num_blocks, np.int64)
        self._gens = np.zeros(num_blocks, np.int64)
        self._count = np.zeros(max_batch, np.int64)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def can_fit(self, n_tokens: int) -> bool:
        """Would a *fresh* slot holding ``n_tokens`` fit right now?"""
        return self.blocks_for(n_tokens) <= self.free_blocks

    def owned(self, slot: int) -> int:
        return int(self._count[slot])

    def refcount(self, blk: int) -> int:
        """How many live table occurrences reference physical block ``blk``
        (0 = free/cached). A block with refcount > 1 is read-only."""
        return int(self._refs[blk])

    def generation(self, blk: int) -> int:
        """Allocation generation of ``blk`` — bumped every time the block is
        popped off the free list (its content is about to be overwritten).
        :class:`PrefixIndex` entries record the generation they were indexed
        at; a mismatch means the cached content is gone."""
        return int(self._gens[blk])

    def high_water(self) -> int:
        """Largest per-slot block count currently allocated (≥ 1).

        The serving loop clamps the device-side block tables to this many
        columns before each decode chunk, so neither the reference gather nor
        the kernel's grid walks pages no slot has reached yet — the
        length-clamp that stops a mostly-short workload from paying for
        ``capacity`` worth of empty pages per slot per token."""
        return max(int(self._count.max()), 1)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table until it covers ``n_tokens`` positions.

        Returns False (allocating nothing) when the free list cannot cover
        the growth — the caller preempts and retries. Coverage is capped at
        ``capacity`` (the table length)."""
        need = min(self.blocks_for(n_tokens), self.max_blocks) - self.owned(slot)
        if need <= 0:
            return True
        if need > self.free_blocks:
            return False
        for _ in range(need):
            self._append(slot, self._pop_fresh())
        return True

    def _pop_fresh(self) -> int:
        """Pop the oldest free block for (re)use: refcount 0 -> 1, generation
        bumped so any :class:`PrefixIndex` entry for its old content dies."""
        blk = self._free.pop(0)
        if self._refs[blk] != 0:
            raise AssertionError(
                f"block {blk} double-allocated (refcount {self._refs[blk]})")
        self._refs[blk] = 1
        self._gens[blk] += 1
        return blk

    def _append(self, slot: int, blk: int) -> None:
        self.tables[slot, self._count[slot]] = blk
        self._count[slot] += 1

    def attach(self, slot: int, blocks) -> None:
        """Append already-indexed physical ``blocks`` to ``slot``'s table,
        bumping each refcount — the shared-prefix admission path: the blocks
        were written once by an earlier request's prefill and this slot now
        aliases them read-only. Blocks whose refcount already dropped to 0
        are revived off the free list (content + generation intact; the
        caller validated freshness through :class:`PrefixIndex`)."""
        blocks = [int(b) for b in blocks]
        if self.owned(slot) + len(blocks) > self.max_blocks:
            raise AssertionError(
                f"slot {slot} table overflow: {self.owned(slot)} + "
                f"{len(blocks)} > {self.max_blocks}")
        for blk in blocks:
            if not 0 <= blk < self.num_blocks:
                raise AssertionError(f"attach of invalid block {blk}")
            if self._refs[blk] == 0:
                self._free.remove(blk)   # revive: content kept, gen unchanged
            self._refs[blk] += 1
            self._append(slot, blk)

    def needs_fork(self, slot: int, page: int) -> bool:
        """Would a write through ``tables[slot, page]`` hit a shared block?
        Shared blocks are read-only: the engine checks this for every live
        slot's tail page before a decode chunk and forks first."""
        if not 0 <= page < self.owned(slot):
            return False   # unallocated page: ensure() will pop a fresh one
        return self.refcount(int(self.tables[slot, page])) > 1

    def fork_for_write(self, slot: int, page: int) -> tuple[int, int] | None:
        """Copy-on-write fork: make ``tables[slot, page]`` exclusive before
        the fused tail append writes through it.

        Returns ``(old, new)`` when a fork happened — the caller must mirror
        it on device with :func:`copy_block` — or None when the page is
        already exclusive (or unallocated). Raises when a fork is needed but
        the free list is empty; the engine preempts to make room before
        calling (see :meth:`needs_fork`)."""
        if not self.needs_fork(slot, page):
            return None
        if not self._free:
            raise RuntimeError(
                f"fork of slot {slot} page {page} needs a free block")
        old = int(self.tables[slot, page])
        new = self._pop_fresh()
        self._refs[old] -= 1
        self.tables[slot, page] = new
        return old, new

    def trim(self, slot: int, n_tokens: int) -> int:
        """Shrink ``slot``'s table to cover exactly ``n_tokens`` positions,
        releasing the tail blocks past it — the speculative-decode rewind:
        ``ensure`` grew the table for the chunk's worst-case window, the
        verify rejected part of it, and the now-empty tail blocks (they hold
        only rejected-candidate garbage past the slot's valid length) go
        back to the free list. Returns the number of blocks released.

        Release semantics match :meth:`release` per block (decrement once
        per occurrence, free-list tail at refcount 0), so a shared tail —
        impossible in the serving flow, where trimmed blocks are always
        fresh ``ensure`` pops, but legal for the model checker — just drops
        this slot's reference."""
        keep = min(self.blocks_for(n_tokens), self.max_blocks)
        dropped = 0
        while self.owned(slot) > keep:
            self._count[slot] -= 1
            j = int(self._count[slot])
            blk = int(self.tables[slot, j])
            self.tables[slot, j] = self.trash
            if self._refs[blk] < 1:
                raise AssertionError(
                    f"slot {slot} trimming block {blk} with refcount "
                    f"{self._refs[blk]}")
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                self._free.append(blk)
            dropped += 1
        return dropped

    def release(self, slot: int) -> None:
        """Drop one reference per block the slot's table holds and reset the
        table to trash; blocks reaching refcount 0 rejoin the free-list tail
        (still revivable through :meth:`attach` until reallocated)."""
        for j in range(self.owned(slot)):
            blk = int(self.tables[slot, j])
            if self._refs[blk] < 1:
                raise AssertionError(
                    f"slot {slot} freeing block {blk} with refcount "
                    f"{self._refs[blk]}")
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                self._free.append(blk)
        self.tables[slot, :] = self.trash
        self._count[slot] = 0


class PrefixMatch(NamedTuple):
    """Result of a :meth:`PrefixIndex.match`: the longest resident run of
    physical blocks whose cached K/V covers a prompt prefix."""
    blocks: tuple[int, ...]   # physical blocks, logical page order
    n_tokens: int             # prompt tokens the run covers
    exact: bool               # whole prompt matched (incl. a partial tail)
    first_tok: int | None     # cached greedy first token (exact hits only)


class PrefixIndex:
    """Content-hash index from prompt prefixes to resident physical blocks.

    Two entry kinds, both recorded when a request's prefill lands:

    * **chain** — hash of the first ``k * block_size`` prompt tokens -> the
      physical block holding page ``k - 1``, for every full block the prompt
      fills. A lookup walks k = 1, 2, ... and stops at the first miss, so
      any two prompts sharing a prefix share its full blocks.
    * **exact** — hash of the whole prompt -> all its pages (including a
      partial tail block) plus the prefill's greedy first token. An exact
      resubmission (same system prompt + same user query, or a preempted
      request restarting) skips prefill compute entirely: it attaches the
      cached blocks and starts decoding from the cached first token.

    Entries are ``(block, generation)`` pairs validated against the
    allocator on every lookup: a block popped off the free list since it
    was indexed has a bumped generation and the entry is dropped lazily —
    release never has to notify the index, which is what lets freed blocks
    stay matchable until the moment they are actually reused.

    Sharing is sound because prefill K/V at a given position depends only
    on the tokens at positions <= it: an attached page holds what this
    request's own prefill would have written (bit for bit wherever the
    backend's matmul rounding does not depend on the prompt's length), and
    positions past a request's own length are masked out of its attention
    reads.
    """

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self._chain: dict[bytes, tuple[int, int]] = {}
        self._exact: dict[bytes, tuple[tuple[tuple[int, int], ...], int]] = {}

    @staticmethod
    def _key(tokens) -> bytes:
        return hashlib.sha1(
            np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes()
        ).digest()

    def _fresh(self, blk: int, gen: int) -> bool:
        return self.alloc.generation(blk) == gen

    def match(self, prompt) -> PrefixMatch | None:
        """Longest cached prefix of ``prompt``; stale entries are pruned on
        the way. Matched blocks may be live (refcount > 0) or freed-but-
        cached (refcount 0, still on the free list): both attach, but only
        live ones cost no free-list headroom — admission accounting treats
        them differently (see ``ServeEngine._admission_need``)."""
        prompt = np.asarray(prompt, np.int32)
        bs = self.alloc.block_size
        kx = self._key(prompt)
        hit = self._exact.get(kx)
        if hit is not None:
            entry, first_tok = hit
            if all(self._fresh(b, g) for b, g in entry):
                return PrefixMatch(tuple(b for b, _ in entry),
                                   len(prompt), True, first_tok)
            del self._exact[kx]   # some page was reallocated: entry is dead
        blocks: list[int] = []
        for k in range(1, len(prompt) // bs + 1):
            key = self._key(prompt[:k * bs])
            e = self._chain.get(key)
            if e is None:
                break
            if not self._fresh(*e):
                del self._chain[key]
                break
            blocks.append(e[0])
        if not blocks:
            return None
        return PrefixMatch(tuple(blocks), len(blocks) * bs, False, None)

    def record(self, prompt, blocks, first_tok: int) -> None:
        """Index a freshly prefilled prompt: ``blocks`` is its slot's live
        table prefix (page order), ``first_tok`` the greedy token its
        prefill produced. Chain entries cover the full blocks; the exact
        entry covers every page including a partial tail — its offsets past
        ``len(prompt)`` hold whatever the owner decodes later, which any
        future attacher masks out (and never overwrites without a fork)."""
        prompt = np.asarray(prompt, np.int32)
        bs = self.alloc.block_size
        blocks = [int(b) for b in blocks]
        for k in range(1, len(prompt) // bs + 1):
            b = blocks[k - 1]
            self._chain[self._key(prompt[:k * bs])] = (
                b, self.alloc.generation(b))
        pages = blocks[:self.alloc.blocks_for(len(prompt))]
        self._exact[self._key(prompt)] = (
            tuple((b, self.alloc.generation(b)) for b in pages),
            int(first_tok))


class BlockPool:
    """Physical paged KV cache + host-side block allocator.

    Device side: one ``[num_blocks + 1, block_size, *rest]`` tensor per
    per-token cache leaf in ``cfg.dtype`` (index ``num_blocks`` is the trash
    block), ``rest`` being the leaf's shape without its batch and capacity
    axes: ``.data = {"kv": {"k", "v"}}``, each ``[num_blocks + 1,
    block_size, L, Hkv, Dh]``. As in the JAX package, the axes come from
    :func:`~repro_torch.models.cache_batch_axes` and
    :func:`~repro_torch.models.cache_capacity_axes`, and a family with a
    leaf that lacks either (recurrent state, cross-attention caches) is
    refused. Host side: a :class:`BlockAllocator` (free list, refcounts,
    per-slot ``[max_blocks]`` int32 block tables; unallocated entries point
    at trash). Host-side forks (:meth:`fork_for_write`) must be mirrored on
    ``.data`` with :func:`copy_block`.
    """

    def __init__(self, cfg: ModelConfig, *, num_blocks: int, block_size: int,
                 max_batch: int, capacity: int, device: torch.device,
                 params=None):
        self.alloc = BlockAllocator(num_blocks=num_blocks,
                                    block_size=block_size,
                                    max_batch=max_batch, capacity=capacity)
        self.num_blocks, self.block_size = num_blocks, block_size
        self.max_blocks = self.alloc.max_blocks
        strip = (lambda t: {k: v for k, v in t.items() if k != "idx"})
        self.batch_axes = strip(cache_batch_axes(cfg, capacity,
                                                 params=params))
        self.cap_axes = strip(cache_capacity_axes(cfg, capacity,
                                                  params=params))
        pairs = list(zip(pytree.tree_leaves(self.batch_axes),
                         pytree.tree_leaves(self.cap_axes)))
        if not pairs or any(b < 0 or c < 0 for b, c in pairs):
            raise ValueError(
                f"family {cfg.family!r} has cache leaves without a "
                "(batch, capacity) axis pair — paged KV needs every "
                "per-token tensor to grow with capacity")
        shapes = strip(init_cache(cfg, 1, capacity, device="meta",
                                  params=params))

        def phys(leaf, b, c):
            rest = [s for ax, s in enumerate(leaf.shape) if ax not in (b, c)]
            return torch.zeros((num_blocks + 1, block_size, *rest),
                               dtype=leaf.dtype, device=device)

        self.data = pytree.tree_map(phys, shapes, self.batch_axes,
                                    self.cap_axes)

    # -- allocator (delegates to BlockAllocator) ----------------------------

    @property
    def trash(self) -> int:
        return self.alloc.trash

    @property
    def tables(self) -> np.ndarray:
        return self.alloc.tables

    @property
    def free_blocks(self) -> int:
        return self.alloc.free_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return self.alloc.blocks_for(n_tokens)

    def owned(self, slot: int) -> int:
        return self.alloc.owned(slot)

    def high_water(self) -> int:
        return self.alloc.high_water()

    def refcount(self, blk: int) -> int:
        return self.alloc.refcount(blk)

    def shared_blocks(self) -> int:
        """Blocks currently aliased by more than one table entry."""
        return int((self.alloc._refs > 1).sum())

    def ensure(self, slot: int, n_tokens: int) -> bool:
        return self.alloc.ensure(slot, n_tokens)

    def attach(self, slot: int, blocks) -> None:
        self.alloc.attach(slot, blocks)

    def needs_fork(self, slot: int, page: int) -> bool:
        return self.alloc.needs_fork(slot, page)

    def fork_for_write(self, slot: int, page: int) -> tuple[int, int] | None:
        """Host-side CoW fork; the caller MUST mirror a non-None return on
        ``.data`` with :func:`copy_block` before the next decode chunk."""
        return self.alloc.fork_for_write(slot, page)

    def trim(self, slot: int, n_tokens: int) -> int:
        return self.alloc.trim(slot, n_tokens)

    def release(self, slot: int) -> None:
        self.alloc.release(slot)
