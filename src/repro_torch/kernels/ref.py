"""Plain PyTorch versions of the port's kernels (full softmax, no blocking).

Each transcribes its oracle in ``repro.kernels.ref``. The CPU path of every
kernel wrapper runs these, the CPU tests hold them against the JAX oracles,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, tables, lengths, layer=0):
    """Decode attention through a block table, full-softmax oracle.

    q: [B, H, Dh] (one new token per slot); k_pages/v_pages:
    [num_blocks + 1, block_size, L, Hkv, Dh] physical pool (trailing block is
    trash); tables: [B, n_pages] int32; lengths: [B] int32 valid KV count per
    slot (0 = dead slot -> zeros out); layer: which transformer layer to read.

    Gathers each slot's pages into a dense [n_pages * block_size] logical
    cache, then runs one masked softmax in f32.
    """
    B, H, Dh = q.shape
    _, block_size, _, Hkv, _ = k_pages.shape
    G = H // Hkv
    kl = k_pages[:, :, layer]                      # [N+1, bs, Hkv, Dh]
    vl = v_pages[:, :, layer]
    t = tables.long()
    k = kl[t].reshape(B, -1, Hkv, Dh)              # [B, n_pages*bs, Hkv, Dh]
    v = vl[t].reshape(B, -1, Hkv, Dh)
    qg = q.reshape(B, Hkv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float())
    valid = (torch.arange(s.shape[-1], device=q.device)[None]
             < lengths.long()[:, None])            # [B, S]
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)   # dead slots: fully-masked rows
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, H, Dh).to(q.dtype)
