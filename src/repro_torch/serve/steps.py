"""Serving step functions: prefill, the dense slot decode step (the
speculative draft's) and the paged decode chunk.

:func:`make_paged_kernel_decode` is the counterpart of the JAX package's
``make_paged_kernel_decode``: ``decode_chunk`` greedy tokens for every slot
per call, with EOS and budget masking applied on the device so finished
slots stop emitting without a host round trip per token. The JAX package
fuses the chunk into one ``lax.scan`` program with donated buffers; here it
is a Python loop over :func:`repro_torch.models.paged.paged_decode_step`
that updates the pool in place and reads nothing back to the host.

The tables handed to the decode chunk may alias a physical page across
slots (shared-prefix copy-on-write). Reads are safe; the tail append writes
through ``tables[i, idx // block_size]``, so the engine's pre-chunk fork
pass makes each live slot's write page exclusive first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import paged_decode_step
from repro_torch.serve.batch import tail_targets


def make_prefill_step(cfg: ModelConfig, capacity: int):
    def step(params, batch):
        return prefill(cfg, params, batch["tokens"], capacity,
                       length=batch.get("length"))
    return step


def make_slot_decode_step(cfg: ModelConfig):
    """Greedy one-token decode of every slot of a slot-layout cache
    (:func:`repro_torch.serve.batch.init_slot_cache`): ``(params, tok [B],
    cache) -> (next_tok [B], cache)``, each slot at its own
    ``cache["idx"][slot]``, the K/V written in place. The JAX package vmaps
    ``decode_step`` over the slots; here they are one batch."""
    def step(params, tok, cache):
        logits, cache = decode_step(cfg, params, tok[:, None], cache)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return step


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
            emit = live
            remaining = torch.where(emit, remaining - 1, remaining)
            live = live & (remaining > 0)
            if eos_id is not None:
                live = live & ~(emit & (next_tok == eos_id))
            tok = torch.where(emit, next_tok, tok)
            idx = idx + 1
            tokens.append(next_tok)
            emitted.append(emit)
        return (tok, {"kv": pool_kv}, idx, live, remaining,
                torch.stack(tokens), torch.stack(emitted))

    return chunk
