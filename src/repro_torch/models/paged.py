"""Block-native paged decode step for the dense family.

Per layer, the new token's K/V are written straight into each slot's tail
block, then attention walks the block table itself through ``attend`` (the
CUDA kernel on the card, its plain version on the CPU). Everything outside
attention — norms, QKV/output projections, the MLP — is batched over slots.

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
from repro_torch.models.layers import (apply_norm, dense, embed, mlp, rope,
                                       unembed)
from repro_torch.models.transformer import layer_params


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
    if cfg.family != "dense":
        raise NotImplementedError(
            f"paged decode for family={cfg.family!r}: the port has the dense "
            "branch only (ROADMAP.md, queue 1, remaining model families)")
    B = tok.shape[0]
    x = embed(cfg, params["embed"], tok[:, None])          # [B, 1, D]
    pos = positions[:, None]                               # [B, 1]
    pk, pv = pool_kv["k"], pool_kv["v"]
    blk, off = blk.long(), off.long()
    for layer in range(cfg.n_layers):
        lp = layer_params(params["layers"], layer)
        hn = apply_norm(cfg, lp["norm1"], x)
        q, k, v = qkv(cfg, lp["attn"], hn)                 # [B,1,H/Hkv,Dh]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        pk[blk, off, layer] = k[:, 0].to(pk.dtype)
        pv[blk, off, layer] = v[:, 0].to(pv.dtype)
        a = attend(q[:, 0].contiguous(), pk, pv, tables, lengths, layer)
        x = x + dense(lp["attn"]["wo"], a.reshape(B, 1, -1), cfg.dtype)
        x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits[:, -1], pool_kv
