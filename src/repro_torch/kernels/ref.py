"""Plain PyTorch versions of the port's kernels (full softmax, no blocking).

Each transcribes its oracle in ``repro.kernels.ref``. The CPU path of every
kernel wrapper runs these, the CPU tests hold them against the JAX oracles,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def paged_attention_multi_ref(q, k_pages, v_pages, tables, lengths, layer=0):
    """Attention for a window of Q tokens per slot through a block table,
    full-softmax oracle (the speculative verify read).

    q: [B, Q, H, Dh] — Q tokens per slot, already appended to the pool at
    positions ``lengths - Q .. lengths - 1``; k_pages/v_pages:
    [num_blocks + 1, block_size, L, Hkv, Dh] physical pool (trailing block is
    trash); tables: [B, n_pages] int32; lengths: [B] int32 valid KV count per
    slot after all Q appends (0 = dead slot -> zeros out); layer: which
    transformer layer to read.

    Gathers each slot's pages into a dense [n_pages * block_size] logical
    cache, then runs one masked softmax in f32. Row ``r`` attends positions
    ``< lengths - (Q - 1 - r)``; a row with nothing to attend gives zeros.
    """
    B, Q, H, Dh = q.shape
    _, block_size, _, Hkv, _ = k_pages.shape
    G = H // Hkv
    kl = k_pages[:, :, layer]                      # [N+1, bs, Hkv, Dh]
    vl = v_pages[:, :, layer]
    t = tables.long()
    k = kl[t].reshape(B, -1, Hkv, Dh)              # [B, n_pages*bs, Hkv, Dh]
    v = vl[t].reshape(B, -1, Hkv, Dh)
    qg = q.reshape(B, Q, Hkv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    rows = torch.arange(Q, device=q.device)
    row_len = lengths.long()[:, None] - (Q - 1 - rows)[None]      # [B, Q]
    valid = (torch.arange(s.shape[-1], device=q.device)[None, None]
             < row_len[:, :, None])                               # [B, Q, S]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)   # fully-masked rows (dead slots)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Q, H, Dh).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, tables, lengths, layer=0):
    """Decode attention through a block table, full-softmax oracle: the
    window of one token, q [B, H, Dh] -> [B, H, Dh] (lengths: valid KV count
    per slot, 0 = dead slot -> zeros out)."""
    return paged_attention_multi_ref(q[:, None], k_pages, v_pages, tables,
                                     lengths, layer)[:, 0]
