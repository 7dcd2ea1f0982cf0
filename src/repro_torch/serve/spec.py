"""Speculative decoding on the paged serving stack: draft-propose, one
multi-token verify, lossless greedy acceptance.

The counterpart of ``repro.serve.spec``. Every decode path is greedy
argmax, so speculation is lossless: a draft model proposes ``k`` tokens,
the target verifies all ``k + 1`` window positions in one batched step
(:func:`repro_torch.models.paged.paged_verify_step`, attention through the
CUDA kernel :func:`repro_torch.kernels.paged_attention_multi`), and
longest-prefix acceptance emits exactly the tokens the target would have
produced one at a time.

One round:

1. **Propose** — the draft (its own slot-layout cache, same
   ``capacity``) is rewound to the target's position by overwriting its
   ``idx`` and greedily decodes ``k + 1`` steps from the current token. The
   first ``k`` outputs are the proposals; the last is discarded, but its
   K/V write matters: a fully accepted window advances past ``idx + k``,
   which would otherwise be a hole in the draft cache next round.
2. **Verify** — the target appends K/V for ``[tok, d_1 .. d_k]`` at
   ``idx .. idx + k`` through the block table (dead slots and positions
   past the table's coverage go to the trash block) and attends all rows
   causally; ``argmax`` per row gives ``t_1 .. t_{k+1}``.
3. **Accept** — the longest prefix with ``d_j == t_j`` (``a`` tokens) is
   emitted plus the bonus token ``t_{a+1}``, under the same EOS/budget
   masking as every decode chunk. ``idx`` advances by the emitted count
   only; rejected positions hold garbage that the next window overwrites
   before any emitted row reads it, and the engine trims now-empty tail
   blocks after the chunk.

The JAX package fuses ``rounds`` rounds into one ``lax.scan`` program;
here they are a Python loop that reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels import paged_attention_multi
from repro_torch.kernels.ref import paged_attention_multi_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged import paged_verify_step
from repro_torch.serve.batch import tail_targets_multi
from repro_torch.serve.steps import make_slot_decode_step


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding engine option (``ServeEngine(speculate=...)``).

    draft_cfg/draft_params: a full-attention KV config (dense, vlm, moe or
    audio) with the target's vocab — e.g. the target's own first layers
    (:func:`repro_torch.weights.truncate_params`), or the target itself
    (acceptance 1).
    k: draft tokens proposed per round (the verify window is ``k + 1``).
    rounds: speculative rounds per dispatch; the default covers at least
    ``decode_chunk`` positions (``ceil(decode_chunk / (k + 1))``).
    """
    draft_cfg: ModelConfig
    draft_params: Any
    k: int = 3
    rounds: int | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculation needs k >= 1, got {self.k}")

    def rounds_for(self, decode_chunk: int) -> int:
        if self.rounds is not None:
            return max(1, self.rounds)
        return max(1, -(-decode_chunk // (self.k + 1)))


# the engine's kv_impl choices, which pick the verify attention too
KV_IMPLS = ("auto", "kernel", "pallas", "reference")


def make_spec_decode(cfg: ModelConfig, draft_cfg: ModelConfig,
                     block_size: int, k: int, rounds: int,
                     eos_id: int | None, *, impl: str = "auto"):
    """The speculative decode chunk: ``rounds`` propose -> verify -> accept
    rounds per call.

    ``impl`` selects the verify attention: ``"reference"`` the plain
    version (:func:`repro_torch.kernels.paged_attention_multi_ref`), as the
    JAX package verifies through its gather oracle; ``"auto"``,
    ``"kernel"`` and ``"pallas"`` the CUDA kernel
    (:func:`repro_torch.kernels.paged_attention_multi`, whose CPU tensors
    take the plain version).

    Signature: ``(params, draft_params, tok [B], pool_data,
    tables [B, n_pages], idx [B], live [B], remaining [B], draft_cache) ->
    (tok, pool_data, idx, live, remaining, tokens [rounds * (k+1), B],
    emitted [rounds * (k+1), B], draft_cache, proposed [rounds, B],
    accepted [rounds, B])``. The tokens/emitted grids are row-major over
    verify rows, as ``SlotScheduler.record_decode`` takes them;
    ``proposed``/``accepted`` are per-round draft counts. The pool and the
    draft cache are updated in place.
    """
    if impl not in KV_IMPLS:
        raise ValueError(f"impl must be one of {KV_IMPLS}, got {impl!r}")
    attend = (paged_attention_multi_ref if impl == "reference"
              else paged_attention_multi)
    draft_step = make_slot_decode_step(draft_cfg)
    Q = k + 1

    def chunk(params, draft_params, tok, pool_data, tables, idx, live,
              remaining, dcache):
        trash = pool_data["kv"]["k"].shape[0] - 1
        B = tok.shape[0]
        pool_kv = pool_data["kv"]
        rows = torch.arange(Q, device=tok.device)
        slots = torch.arange(B, device=tok.device)
        tokens, emitted, proposed, accepted = [], [], [], []
        for _ in range(rounds):
            live_in = live

            # 1. propose: rewind the draft to the target's position (its
            # K/V below idx is exact — accepted inputs are the true stream)
            # and decode Q = k + 1 greedy steps
            dcache = {**dcache, "idx": idx}
            dtok, douts = tok, []
            for _ in range(Q):
                dtok, dcache = draft_step(draft_params, dtok, dcache)
                douts.append(dtok)
            drafts = torch.stack(douts[:k], dim=1)             # [B, k]

            # 2. verify all window rows in one batched step
            qtoks = torch.cat([tok[:, None], drafts], dim=1)
            pos = idx[:, None] + rows.to(idx.dtype)
            blks, offs = tail_targets_multi(tables, idx, live, Q,
                                            block_size, trash)
            lengths = torch.where(live, idx + Q, 0).to(torch.int32)
            logits, pool_kv = paged_verify_step(
                cfg, params, qtoks, pool_kv, tables, blks, offs, pos,
                lengths, attend=attend)
            targets = torch.argmax(logits, dim=-1).to(torch.int32)

            # 3. longest-prefix acceptance (+ the bonus row a)
            match = (drafts == targets[:, :k]).to(torch.int32)
            a = torch.cumprod(match, dim=1).sum(dim=1)      # [B] in [0, k]

            # 4. emission: row j emits iff the slot was live, every prior
            # row emitted (j <= a, no earlier EOS) and the budget reaches
            # it; all masks are prefix-monotone, so the rows form a prefix
            if eos_id is None:
                is_eos = torch.zeros_like(targets, dtype=torch.bool)
            else:
                is_eos = targets == eos_id
            n_eos = is_eos.to(torch.int32)
            eos_before = (torch.cumsum(n_eos, dim=1) - n_eos) > 0
            emit = (live[:, None] & (rows[None] <= a[:, None])
                    & ~eos_before & (rows[None] < remaining[:, None]))
            n_emit = emit.sum(dim=1).to(idx.dtype)
            remaining = remaining - n_emit
            hit_eos = (emit & is_eos).any(dim=1)
            live = live & ~hit_eos & (remaining > 0)
            last = torch.clamp(n_emit - 1, min=0).long()
            tok = torch.where(n_emit > 0, targets[slots, last], tok)
            idx = idx + n_emit

            proposed.append(torch.where(live_in, k, 0).to(torch.int32))
            accepted.append(torch.where(live_in, a, 0).to(torch.int32))
            tokens.append(targets.T)
            emitted.append(emit.T)
        return (tok, {"kv": pool_kv}, idx, live, remaining,
                torch.cat(tokens), torch.cat(emitted), dcache,
                torch.stack(proposed), torch.stack(accepted))

    return chunk
