"""Attention: GQA projections, the prefill attention, chunked softmax
attention, and the dense one-token decode against a slot-layout KV cache
(full, or a ring for a sliding window).

Prefill attention (:func:`prefill_attention`) goes through
:func:`repro_torch.kernels.ops.attention`: the CUDA flash kernel on the
card, its plain version on the CPU. The JAX package names its Pallas flash
kernel as the TPU-target implementation of this step and runs the chunked
``sdpa`` elsewhere.

``sdpa`` is plain PyTorch — einsum, softmax — in the JAX package's order of
operations (``repro.models.attention.sdpa``): q is scaled in the compute
dtype before the QK product, the scores are cast to f32 after it, the mask
is an additive ``NEG_INF`` bias, and the probabilities are cast back to the
compute dtype before the PV product. Decode against a slot cache uses it,
as the JAX package does (it has no decode kernel for dense slots). Paged
decode attention does not come through here: it walks the block table in
:mod:`repro_torch.kernels`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense, init_dense, rope

NEG_INF = -2.0 ** 30


def init_attn(cfg, gen: torch.Generator, d_model: int | None = None):
    D = d_model or cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    return {
        "wq": init_dense(gen, D, H * Dh, pd, bias=cfg.qkv_bias),
        "wk": init_dense(gen, D, Hkv * Dh, pd, bias=cfg.qkv_bias),
        "wv": init_dense(gen, D, Hkv * Dh, pd, bias=cfg.qkv_bias),
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
    kv_len: optional count of valid cache slots, one for the batch or a
    ``[B]`` tensor, one per row of the batch (slots decoding at their own
    positions).
    Query rows are processed ``chunk`` at a time so the score matrix never
    holds more than ``chunk`` rows; each row's arithmetic is the same.
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = Dh ** -0.5
    qg = (q * scale).reshape(B, Sq, Hkv, G, Dh)
    kv_ok = None
    if kv_len is not None:
        kv_ok = (torch.arange(Skv, device=q.device)[None, :]
                 < torch.as_tensor(kv_len, device=q.device).reshape(-1, 1))

    def block(qb, qpos):
        s = torch.einsum("bchgd,bkhd->bchgk", qb, k).float()
        valid = torch.ones((1, qpos.shape[0], Skv), dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= k_positions[None, :] <= qpos[:, None]
        if window is not None:
            valid &= k_positions[None, :] > qpos[:, None] - window
        if kv_ok is not None:
            valid = valid & kv_ok[:, None, :]          # [1 or B, C, Skv]
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
        s = s + bias[:, :, None, None, :]
        p = torch.softmax(s, dim=-1).to(qb.dtype)
        return torch.einsum("bchgk,bkhd->bchgd", p, v)

    out = torch.cat([block(qg[:, c:c + chunk], q_positions[c:c + chunk])
                     for c in range(0, Sq, chunk)], dim=1)
    return out.reshape(B, Sq, H, Dh)


def prefill_attention(q, k, v, *, causal: bool, window: int | None,
                      attend=ops.attention):
    """Self-attention over a whole prompt, positions 0 .. S-1. q: [B, S, H,
    Dh], k/v: [B, S, Hkv, Dh] -> [B, S, H, Dh].

    ``attend`` takes the kernels' ``[B, H, S, Dh]`` layout:
    :func:`repro_torch.kernels.ops.attention` unless the caller passes
    another (``chip_smoke.py`` replays the model through the plain version
    on the card). The layout change is a view both ways; the CUDA kernel
    reads through strides and writes its output in q's layout."""
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window)
    return out.transpose(1, 2)


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


# ---------------------------------------------------------------------------
# Dense KV cache: one-token decode per slot
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, capacity: int, *, device, dtype=None):
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_self_attention(cfg, p, x, cache, idx, *, window=None):
    """One-token decode for every slot at its own position.

    x: [B, 1, D]; cache k/v [B, C, Hkv, Dh], written in place; idx: [B]
    absolute position of each slot's new token. Returns out [B, 1, D].

    The JAX package vmaps this over slots with a scalar ``idx``; here the
    slots are one batch. With ``window`` set the cache is a ring of
    capacity C: the new K/V land at slot ``idx % C``. Otherwise they land at
    ``min(idx, C - 1)``: JAX's ``dynamic_update_slice`` clamps an
    out-of-range start the same way, which a speculative draft reaches when
    it decodes past a request's budget. RoPE takes the unclamped position;
    slot ``i`` attends its first ``min(idx + 1, C)`` cache positions.
    """
    B = x.shape[0]
    q, k_new, v_new = qkv(cfg, p, x)
    pos = idx[:, None]                                     # [B, 1]
    q = rope(q, pos, cfg.rope_theta)
    k_new = rope(k_new, pos, cfg.rope_theta)
    C = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    at = (idx % C if window is not None else torch.clamp(idx, max=C - 1)
          ).long()
    cache["k"][rows, at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, at] = v_new[:, 0].to(cache["v"].dtype)
    zeros = torch.zeros((C,), dtype=torch.int32, device=x.device)
    # RoPE is baked into the cached keys, so the mask is slot validity only
    out = sdpa(q, cache["k"].to(cfg.dtype), cache["v"].to(cfg.dtype),
               q_positions=zeros[:1], k_positions=zeros, causal=False,
               window=None, kv_len=torch.clamp(idx + 1, max=C))
    return dense(p["wo"], out.reshape(B, 1, -1), cfg.dtype)
