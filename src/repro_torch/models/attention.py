"""Attention: GQA projections and chunked softmax attention (prefill path).

``sdpa`` is plain PyTorch — einsum, softmax — in the JAX package's order of
operations (``repro.models.attention.sdpa``): q is scaled in the compute
dtype before the QK product, the scores are cast to f32 after it, the mask
is an additive ``NEG_INF`` bias, and the probabilities are cast back to the
compute dtype before the PV product. Decode attention does not come through
here: it walks the block table in :mod:`repro_torch.kernels`.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense, init_dense, rope

NEG_INF = -2.0 ** 30


def init_attn(cfg, gen: torch.Generator, d_model: int | None = None):
    D = d_model or cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    return {
        "wq": init_dense(gen, D, H * Dh, pd),
        "wk": init_dense(gen, D, Hkv * Dh, pd),
        "wv": init_dense(gen, D, Hkv * Dh, pd),
        "wo": init_dense(gen, H * Dh, D, pd, scale=(H * Dh) ** -0.5),
    }


def qkv(cfg, p, x):
    """Project to q [B,S,H,Dh], k/v [B,S,Hkv,Dh]."""
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, S = x.shape[:2]
    q = dense(p["wq"], x, cfg.dtype).reshape(B, S, H, Dh)
    k = dense(p["wk"], x, cfg.dtype).reshape(B, S, Hkv, Dh)
    v = dense(p["wv"], x, cfg.dtype).reshape(B, S, Hkv, Dh)
    return q, k, v


def sdpa(q, k, v, *, q_positions, k_positions, causal: bool,
         window: int | None, kv_len=None, chunk: int = 512):
    """Chunked scaled-dot-product attention with GQA head grouping.

    q: [B, Sq, H, Dh];  k/v: [B, Skv, Hkv, Dh]
    q_positions [Sq], k_positions [Skv] — absolute positions for masking.
    kv_len: optional count of valid cache slots.
    Query rows are processed ``chunk`` at a time so the score matrix never
    holds more than ``chunk`` rows; each row's arithmetic is the same.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    qg = (q * scale).reshape(B, Sq, Hkv, G, Dh)

    def block(qb, qpos):
        s = torch.einsum("bchgd,bkhd->bchgk", qb, k).float()
        valid = torch.ones((qpos.shape[0], Skv), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= k_positions[None, :] <= qpos[:, None]
        if window is not None:
            valid &= k_positions[None, :] > qpos[:, None] - window
        if kv_len is not None:
            valid &= (torch.arange(Skv, device=q.device) < kv_len)[None, :]
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        s = s + bias[None, :, None, None, :]
        p = torch.softmax(s, dim=-1).to(qb.dtype)
        return torch.einsum("bchgk,bkhd->bchgd", p, v)

    out = torch.cat([block(qg[:, c:c + chunk], q_positions[c:c + chunk])
                     for c in range(0, Sq, chunk)], dim=1)
    return out.reshape(B, Sq, H, Dh)


def self_attention(cfg, p, x, positions, *, causal=True, window=None,
                   chunk: int = 512):
    """Training / prefill self-attention (no cache)."""
    q, k, v = qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = sdpa(q, k, v, q_positions=positions, k_positions=positions,
               causal=causal, window=window, chunk=chunk)
    B, S = x.shape[:2]
    return dense(p["wo"], out.reshape(B, S, -1), cfg.dtype)
