"""Block-native paged decode and verify steps for the full-attention KV
families (dense, vlm, moe: ``PAGED_FAMILIES``).

Per layer, the new tokens' K/V are written straight into each slot's tail
block(s), then attention walks the block table itself through ``attend``
(the CUDA kernel on the card, its plain version on the CPU). Everything
outside attention — norms, QKV/output projections, the MLP — is batched
over slots and window rows. Decode is the one-token window of the verify.
The MoE layer routes every slot and every window row as a group of its own,
as the reference's ``vmap`` over them does: expert capacity sees one token,
so a neighbour's token never displaces this one's, and the verify drops
exactly what one-token-at-a-time decode would.

The pool is ``{"k", "v"}`` of layout ``[num_blocks + 1, block_size, L, Hkv,
Dh]``. Where the JAX package returns a new pool from a jitted function with
donated buffers, this step writes the pool tensors in place.

Tables may alias physical pages across slots (shared-prefix copy-on-write):
reads are alias-oblivious, but the tail append writes through
``tables[i, blk]``, so the caller hands this step tables whose write pages
are exclusively owned — the engine forks shared tail blocks first.
"""
from __future__ import annotations

from repro_torch.models.attention import qkv
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm, dense, embed, rope, unembed
from repro_torch.models.transformer import KV_FAMILIES, ffn, layer_params


def scatter_tokens(pool_data, writes, blk, off):
    """Multi-token tail append, in place: write ``q`` positions for every
    slot at ``(blk[i, j], off[i, j])`` in one indexed write per tensor.

    writes: ``{"kv": {"k", "v"}}`` leaves ``[B, q, *rest]`` for pool leaves
    ``[num_blocks + 1, block_size, *rest]`` (a view of one layer of the
    pool takes one layer's K/V); blk/off from
    :func:`repro_torch.serve.batch.tail_targets_multi`, so a live slot's
    in-range coordinates are distinct and everything else goes to the trash
    block (where colliding writes are all garbage)."""
    blk, off = blk.long(), off.long()
    for name, pool in pool_data["kv"].items():
        pool[blk, off] = writes["kv"][name].to(pool.dtype)
    return pool_data


def paged_decode_step(cfg: ModelConfig, params, tok, pool_kv, tables, blk,
                      off, positions, lengths, *, attend):
    """One greedy-decode step for every slot, block-native.

    tok: [B] int32 current tokens; pool_kv: ``{"k", "v"}`` physical pools
    ``[num_blocks + 1, block_size, L, Hkv, Dh]``, updated in place;
    tables: [B, n_pages] int32; blk/off: [B] tail-block write coordinates
    for this step (``blk`` already routed to the trash block for dead
    slots); positions: [B] absolute position of the new token per slot;
    lengths: [B] int32 valid KV count *after* the tail append (``idx + 1``
    live, 0 dead).

    ``attend(q [B, H, Dh], k_pages, v_pages, tables, lengths, layer)`` is the
    paged-attention implementation.

    Returns ``(logits [B, V], pool_kv)``: the new K/V land in the tail block
    first, then attention covers positions ``< idx + 1``.
    """
    def attend_one(q, k_pages, v_pages, tables, lengths, layer):
        return attend(q[:, 0].contiguous(), k_pages, v_pages, tables,
                      lengths, layer)[:, None]

    logits, pool_kv = paged_verify_step(
        cfg, params, tok[:, None], pool_kv, tables, blk[:, None],
        off[:, None], positions[:, None], lengths, attend=attend_one)
    return logits[:, -1], pool_kv


def paged_verify_step(cfg: ModelConfig, params, toks, pool_kv, tables, blks,
                      offs, positions, lengths, *, attend):
    """Multi-token verify for speculative decoding: append a window of Q
    tokens to each slot's tail block(s) and attend them causally through the
    block table, all slots and rows in one batch.

    toks: [B, Q] int32 — per slot, the current token followed by Q - 1 draft
    candidates; pool_kv: ``{"k", "v"}`` pools as in
    :func:`paged_decode_step`, updated in place; blks/offs: [B, Q] write
    coordinates for the window (:func:`repro_torch.serve.batch.
    tail_targets_multi` — dead slots and positions past the table's
    coverage already routed to the trash block); positions: [B, Q] absolute
    positions (``idx .. idx + Q - 1`` live); lengths: [B] valid KV count
    after ALL Q appends (``idx + Q`` live, 0 dead).

    ``attend(q [B, Q, H, Dh], k_pages, v_pages, tables, lengths, layer)`` is
    the multi-token paged attention (row ``r`` masks to positions
    ``< lengths - (Q - 1 - r)``: write-then-read causal over the window).

    Returns ``(logits [B, Q, V], pool_kv)``: row ``r``'s argmax is the
    target model's greedy continuation after ``toks[:, :r + 1]``. Rejected
    candidates leave garbage K/V past the accepted length, which the next
    window overwrites before any row can read it. The trash block may take
    several writes to one position (dead slots, positions past coverage);
    only garbage lands there.
    """
    if cfg.family not in KV_FAMILIES:
        raise ValueError(f"paged decode needs one of {KV_FAMILIES}, got "
                         f"family={cfg.family!r}")
    B, Q = toks.shape
    x = embed(cfg, params["embed"], toks)                  # [B, Q, D]
    pk, pv = pool_kv["k"], pool_kv["v"]
    for layer in range(cfg.n_layers):
        lp = layer_params(params["layers"], layer)
        hn = apply_norm(cfg, lp["norm1"], x)
        q, k, v = qkv(cfg, lp["attn"], hn)                 # [B,Q,H/Hkv,Dh]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        scatter_tokens({"kv": {"k": pk[:, :, layer], "v": pv[:, :, layer]}},
                       {"kv": {"k": k, "v": v}}, blks, offs)
        a = attend(q.contiguous(), pk, pv, tables, lengths, layer)
        x = x + dense(lp["attn"]["wo"], a.reshape(B, Q, -1), cfg.dtype)
        x = x + ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x),
                    moe_per_token=True)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), pool_kv
