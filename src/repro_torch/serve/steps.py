"""Serving step functions: prefill, single-token decode, the slot decode
step and its fused chunk (continuous batching and the speculative draft),
the paged decode chunk over either read path, and the abstract decode cache
(:func:`cache_specs`).

:func:`make_fused_decode`, :func:`make_paged_decode` and
:func:`make_paged_kernel_decode` are the counterparts of the JAX package's
functions of those names:
``decode_chunk`` greedy tokens for every slot per call, with EOS and budget
masking applied on the device so finished slots stop emitting without a
host round trip per token. The JAX package fuses the chunk into one
``lax.scan`` program with donated buffers; here it is a Python loop over the
decode step that updates the cache or pool in place and reads nothing back
to the host.

The tables handed to the decode chunk may alias a physical page across
slots (shared-prefix copy-on-write). Reads are safe; the tail append writes
through ``tables[i, idx // block_size]``, so the engine's pre-chunk fork
pass makes each live slot's write page exclusive first.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import attention_ref, paged_attention
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import tree_to
from repro_torch.models.paged import paged_decode_step
from repro_torch.serve.batch import (gather_pages, scatter_token,
                                     slice_token, tail_targets)


def make_prefill_step(cfg: ModelConfig, capacity: int):
    """``(params, batch) -> (logits, cache)``: ``batch`` holds ``tokens``
    and the family extras (``image_embeds``/``image_pos``,
    ``src_embeds``) and ``length`` where there are any."""
    def step(params, batch):
        return prefill(cfg, params, batch["tokens"], capacity,
                       image_embeds=batch.get("image_embeds"),
                       image_pos=batch.get("image_pos"),
                       src_embeds=batch.get("src_embeds"),
                       length=batch.get("length"))
    return step


def make_decode_step(cfg: ModelConfig):
    """``(params, tokens [B, 1], cache) -> (next_tok [B, 1], logits,
    cache)``: one greedy token for a batch at one position (the MoE family
    routes the batch jointly, as the reference's un-vmapped call does)."""
    def step(params, tokens, cache):
        logits, cache = decode_step(cfg, params, tokens, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache
    return step


def make_slot_decode_step(cfg: ModelConfig):
    """Greedy one-token decode of every slot of a slot-layout cache
    (:func:`repro_torch.serve.batch.init_slot_cache`): ``(params, tok [B],
    cache) -> (next_tok [B], cache)``, each slot at its own
    ``cache["idx"][slot]``, the cache written in place (the hybrid family's
    rings at ``idx % capacity``, its recurrent state per slot). The JAX
    package vmaps ``decode_step`` over the slots; here they are one batch,
    and every per-slot computation reads only its own slot's row: the MoE
    family routes each slot as a group of its own (``moe_per_token``), as
    the vmap gives it, where a batched ``moe_mlp`` would share one capacity
    among all slots."""
    def step(params, tok, cache):
        logits, cache = decode_step(cfg, params, tok[:, None], cache,
                                    moe_per_token=True)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return step


def _advance(next_tok, tok, live, remaining, eos_id):
    """One step's emit/EOS/budget masking, as every decode chunk applies
    it: ``(emit, tok, live, remaining)``."""
    emit = live
    remaining = torch.where(emit, remaining - 1, remaining)
    live = live & (remaining > 0)
    if eos_id is not None:
        live = live & ~(emit & (next_tok == eos_id))
    return emit, torch.where(emit, next_tok, tok), live, remaining


def make_fused_decode(cfg: ModelConfig, decode_chunk: int,
                      eos_id: int | None):
    """Continuous-batching decode: ``decode_chunk`` greedy tokens for every
    slot of a slot-layout cache per call.

    Signature: ``(params, tok [B], cache, live [B] bool, remaining [B]) ->
    (tok, cache, live, remaining, tokens [chunk, B], emitted [chunk, B])``.
    A slot is ``live`` while it is occupied, has budget left and has not
    emitted EOS; ``emitted[s, i]`` marks ``tokens[s, i]`` as a real
    generation for slot ``i``. Dead slots keep decoding (their results are
    masked out, and their slot is overwritten whole at the next admission),
    as in the JAX package's scan. The cache is updated in place and
    returned.
    """
    slot_step = make_slot_decode_step(cfg)

    def chunk(params, tok, cache, live, remaining):
        tokens, emitted = [], []
        for _ in range(decode_chunk):
            next_tok, cache = slot_step(params, tok, cache)
            emit, tok, live, remaining = _advance(next_tok, tok, live,
                                                  remaining, eos_id)
            tokens.append(next_tok)
            emitted.append(emit)
        return (tok, cache, live, remaining, torch.stack(tokens),
                torch.stack(emitted))

    return chunk


def make_paged_decode(cfg: ModelConfig, block_size: int, decode_chunk: int,
                      eos_id: int | None):
    """Paged decode over the ``kv_impl="reference"`` read path: the same
    signature and emit/EOS/budget masking as
    :func:`make_paged_kernel_decode`.

    Per step, each slot gathers its logical dense cache from the pool
    through its block table (:func:`~repro_torch.serve.batch.gather_pages`,
    as wide as the tables the engine hands over), runs the unmodified
    :func:`repro_torch.models.decode_step` on it at batch 1 — so the
    arithmetic is the serial single-request computation's — and hands back
    the token's K/V (:func:`~repro_torch.serve.batch.slice_token`). Every
    slot reads the pool as it was before the step; then one
    :func:`~repro_torch.serve.batch.scatter_token` appends all slots' K/V to
    their tail blocks, dead slots into the trash block. The JAX package
    vmaps the per-slot step; here it is a loop over the slots. Plain
    PyTorch throughout: no kernel is on this path.
    """
    def chunk(params, tok, pool_data, tables, idx, live, remaining):
        trash = pool_data["kv"]["k"].shape[0] - 1
        tokens, emitted = [], []
        for _ in range(decode_chunk):
            nexts, writes = [], []
            for i in range(tok.shape[0]):
                dense = gather_pages(pool_data, tables[i])
                logits, new = decode_step(cfg, params, tok[i].reshape(1, 1),
                                          {**dense, "idx": idx[i]})
                nexts.append(torch.argmax(logits[0, -1]).to(torch.int32))
                writes.append(slice_token(new, idx[i]))
            blk, off = tail_targets(tables, idx, live, block_size, trash)
            scatter_token(pool_data, {"kv": {
                name: torch.stack([w["kv"][name] for w in writes])
                for name in ("k", "v")}}, blk, off)
            next_tok = torch.stack(nexts)
            emit, tok, live, remaining = _advance(next_tok, tok, live,
                                                  remaining, eos_id)
            idx = idx + 1
            tokens.append(next_tok)
            emitted.append(emit)
        return (tok, pool_data, idx, live, remaining, torch.stack(tokens),
                torch.stack(emitted))

    return chunk


def make_paged_kernel_decode(cfg: ModelConfig, block_size: int,
                             decode_chunk: int, eos_id: int | None):
    """Paged decode over the block-native read path.

    Signature: ``(params, tok [B], pool_data, tables [B, n_pages], idx [B],
    live [B] bool, remaining [B]) -> (tok, pool_data, idx, live, remaining,
    tokens [chunk, B], emitted [chunk, B])``. A slot is ``live`` while it is
    occupied, has budget left and has not emitted EOS; ``emitted[s, i]``
    marks ``tokens[s, i]`` as a real generation for slot ``i``, which
    ``SlotScheduler.record_decode`` folds into the request streams. Dead
    slots keep stepping with their writes routed to the trash block.

    Attention is :func:`repro_torch.kernels.paged_attention` (the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors).
    ``pool_data`` is updated in place and returned.
    """
    def chunk(params, tok, pool_data, tables, idx, live, remaining):
        trash = pool_data["kv"]["k"].shape[0] - 1
        pool_kv = pool_data["kv"]
        tokens, emitted = [], []
        for _ in range(decode_chunk):
            blk, off = tail_targets(tables, idx, live, block_size, trash)
            lengths = torch.where(live, idx + 1, 0).to(torch.int32)
            logits, pool_kv = paged_decode_step(
                cfg, params, tok, pool_kv, tables, blk, off, idx, lengths,
                attend=paged_attention)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            emit, tok, live, remaining = _advance(next_tok, tok, live,
                                                  remaining, eos_id)
            idx = idx + 1
            tokens.append(next_tok)
            emitted.append(emit)
        return (tok, {"kv": pool_kv}, idx, live, remaining,
                torch.stack(tokens), torch.stack(emitted))

    return chunk


def cache_specs(cfg: ModelConfig, batch: int, capacity: int,
                src_len: int | None = None):
    """The decode cache's shapes and dtypes, allocating nothing: the tree of
    :func:`repro_torch.models.init_cache` with ``meta`` tensors for leaves
    and ``idx = capacity - 1``. The audio family's cache runs its encoder
    over ``src_embeds``; its parameters and frames are fake tensors here, as
    the JAX package's ``eval_shape`` keeps them abstract, and its attention
    is the plain version, which computes only shapes on them."""
    with FakeTensorMode():
        params = src = None
        if cfg.family == "audio":
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
            src = torch.zeros((batch, src_len or cfg.src_len, cfg.d_model),
                              dtype=cfg.dtype)
        cache = init_cache(cfg, batch, capacity, device="cpu",
                           src_embeds=src, params=params,
                           attend=attention_ref)
    cache = tree_to({k: v for k, v in cache.items() if k != "idx"},
                    device="meta")
    return {**cache, "idx": capacity - 1}
