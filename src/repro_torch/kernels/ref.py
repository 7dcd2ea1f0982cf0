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


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """Blocked attention's oracle: one full softmax in f32.

    q: [B, H, Sq, Dh]; k/v: [B, Hkv, Skv, Dh] -> [B, H, Sq, Dh] in q's
    dtype. Query head h reads KV head ``h * Hkv // H``; query i and key j
    sit at positions i and j. ``causal`` masks j > i, ``window`` masks
    j <= i - window; masked scores are -inf, and a row with nothing to attend
    gives zeros."""
    B, H, Sq, Dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Sq, Dh).float() * Dh ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # masked rows
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, Dh).to(q.dtype)


def rglru_ref(a, x):
    """The linear recurrence ``h_t = a_t * h_{t-1} + x_t`` from ``h_0 = 0``,
    step by step. a/x: [B, S, R] -> h [B, S, R]. The carry stays in the
    inputs' dtype, as the JAX oracle's and the JAX model's ``lax.scan``
    carry it (the CUDA kernel carries it in f32)."""
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _wkv_recurrence(r, k, v, w, u, state):
    """The WKV recurrence, step by step, in f32: r/k/v/w ``[..., S, Dh]``,
    u ``[..., Dh]`` (broadcast over the leading axes), state ``[..., Dh,
    Dh]`` -> (y ``[..., S, Dh]``, final state). Each step

        y_t = r_t · (S_t + (u ⊙ k_t) v_tᵀ)
        S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

    with the JAX package's roundings: ``k v`` once, ``u (k v)`` once, each
    sum once, ``w S`` once."""
    ys = []
    u = u[..., :, None]
    for r_t, k_t, v_t, w_t in zip(*(x.unbind(-2) for x in (r, k, v, w))):
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append((r_t[..., None, :] @ (state + u * kv))[..., 0, :])
        state = w_t[..., :, None] * state + kv
    return torch.stack(ys, dim=-2), state


def wkv6_ref(r, k, v, w, u):
    """RWKV-6 WKV oracle, the JAX package's ``wkv6_ref`` transcribed: r/k/v/w
    ``[BH, S, Dh]``, u ``[BH, Dh]`` -> y ``[BH, S, Dh]`` in r's dtype, from a
    zero state, computed in f32."""
    BH, _, Dh = r.shape
    y, _ = _wkv_recurrence(*(t.float() for t in (r, k, v, w, u)),
                           torch.zeros((BH, Dh, Dh), dtype=torch.float32,
                                       device=r.device))
    return y.to(r.dtype)


def wkv6_scan_ref(r, k, v, w, u, s0=None):
    """The model's WKV scan, the JAX model's ``_wkv_scan`` transcribed, and
    the plain version of :func:`repro_torch.kernels.wkv6_scan`: r/k/v/w
    ``[B, S, H, Dh]`` (any dtype, widened to f32), u ``[H, Dh]``, s0 ``[B,
    H, Dh, Dh]`` f32 or None (zeros) -> (y ``[B, S, H, Dh]`` in r's dtype,
    the final state ``[B, H, Dh, Dh]`` f32)."""
    B, _, H, Dh = r.shape
    state = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    y, s_t = _wkv_recurrence(*(t.float().transpose(1, 2)
                               for t in (r, k, v, w)), u.float(), state)
    return y.transpose(1, 2).to(r.dtype), s_t
