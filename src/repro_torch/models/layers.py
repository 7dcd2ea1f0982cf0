"""Primitive layers: RMSNorm, RoPE, projections (with an optional bias
``b``, the QKV bias of ``qwen2.5-3b``), the SwiGLU and GELU MLPs, tied
embeddings. Parameters are nested dicts of tensors with the JAX package's
names and layouts (``w`` is ``[d_in, d_out]``), so weights carry over
unchanged. The variants other families use (LayerNorm, logit soft-capping)
are not ported yet; ``models.transformer.require_ported`` rejects configs
that need them.

The arithmetic follows ``repro.models.layers`` step by step — where a value
is cast, and in which dtype a statistic is taken — because the port is held
against it."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None, bias: bool = False):
    scale = scale if scale is not None else d_in ** -0.5
    w = (torch.randn((d_in, d_out), generator=gen, device=gen.device)
         * scale).to(dtype)
    if bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=dtype,
                                         device=gen.device)}
    return {"w": w}


def dense(p, x, dtype):
    y = x @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def rms_norm(x, w, eps: float = 1e-6):
    # statistics in f32, the tensor stays in the compute dtype; the scale is
    # (1 + w) with w initialised at zero
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + w.to(x.dtype))


def make_norm_params(cfg, d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=cfg.param_dtype, device=device)}


def apply_norm(cfg, p, x):
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]. Split halves
    (not interleaved), angles in f32, output cast back to x's dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq      # [..., S, half]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator):
    D, Fd = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    p = {"wi": init_dense(gen, D, Fd, pd)["w"]}
    if cfg.act == "swiglu":
        p["wg"] = init_dense(gen, D, Fd, pd)["w"]
    p["wo"] = init_dense(gen, Fd, D, pd, scale=Fd ** -0.5)["w"]
    return p


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (the exact erf form
    differs by ~1e-3, enough to flip a near-tie token)."""
    return F.gelu(x, approximate="tanh")


def mlp(cfg, p, x):
    """SwiGLU, or a GELU MLP (no gate) with ``act="gelu"``."""
    dt = cfg.dtype
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    else:
        h = gelu(x @ p["wi"].to(dt))
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding (tied)
# ---------------------------------------------------------------------------

def init_embed(cfg, gen: torch.Generator):
    emb = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                       device=gen.device)
           * cfg.d_model ** -0.5).to(cfg.param_dtype)
    return {"table": emb}


def embed(cfg, p, tokens):
    return p["table"][tokens].to(cfg.dtype)


def unembed(cfg, p, x):
    return x @ p["table"].to(cfg.dtype).T
