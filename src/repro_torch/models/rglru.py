"""RecurrentGemma building blocks: causal conv1d + RG-LRU recurrence.

RG-LRU (Real-Gated Linear Recurrent Unit, De et al. 2024):

    r_t = σ(W_a x_t + b_a)                  recurrence gate
    i_t = σ(W_x x_t + b_x)                  input gate
    a_t = exp(−c · softplus(Λ) ⊙ r_t)       c = 8
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The counterpart of ``repro.models.rglru``, cast for cast. The prefill path
runs its recurrence through ``scan`` — by default
:func:`repro_torch.kernels.ops.rglru`, the CUDA kernel on the card and the
plain version on the CPU; decode is one recurrence step with a rolling conv
window. The training forward passes :func:`scan_steps`, the JAX model's own
step-by-step recurrence, which every ``torch.func`` transform can
differentiate (the kernel has no derivative in either package).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import fold
from repro_torch.kernels import ops
from repro_torch.models.layers import gelu, init_dense

C_RGLRU = 8.0


def init_recurrent_block(cfg, gen: torch.Generator):
    """Same tree and scales as the JAX package's; the draws differ."""
    D = cfg.d_model
    R = cfg.lru_width or D
    pd = cfg.param_dtype
    dev = gen.device
    lam = torch.rand((R,), generator=gen, device=dev) * (0.85 - 0.43) + 0.43
    # softplus^{-1} so that a^(1/c) starts in [0.9, 0.999]-ish
    lam = torch.log(torch.exp(-torch.log(lam)) - 1.0)
    W = cfg.conv1d_width
    return {
        "w_in_x": init_dense(gen, D, R, pd)["w"],       # recurrent branch
        "w_in_g": init_dense(gen, D, R, pd)["w"],       # gate branch
        "conv_w": (torch.randn((W, R), generator=gen, device=dev)
                   * W ** -0.5).to(pd),
        "conv_b": torch.zeros((R,), dtype=pd, device=dev),
        "w_a": init_dense(gen, R, R, pd, bias=True),
        "w_i": init_dense(gen, R, R, pd, bias=True),
        "lam": lam.to(pd),
        "w_out": init_dense(gen, R, D, pd, scale=R ** -0.5)["w"],
    }


def _gates(p, x, dtype):
    """(a in ``dtype``, gated input): the decay is formed in f32 and cast,
    as the JAX package forms it."""
    r = torch.sigmoid(x @ p["w_a"]["w"].to(dtype) + p["w_a"]["b"].to(dtype))
    i = torch.sigmoid(x @ p["w_i"]["w"].to(dtype) + p["w_i"]["b"].to(dtype))
    log_a = -C_RGLRU * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)).to(dtype) \
        * (i * x)
    return a.to(dtype), gated_in


def causal_conv1d(p, x, dtype):
    """Depthwise causal conv. x: [B, S, R]."""
    w = p["conv_w"].to(dtype)                      # [W, R]
    W = w.shape[0]
    pads = F.pad(x, (0, 0, W - 1, 0))
    out = pads[:, 0:x.shape[1]] * w[0]
    for i in range(1, W):
        out = out + pads[:, i:i + x.shape[1]] * w[i]
    return out + p["conv_b"].to(dtype)


def scan_steps(a, x):
    """``h_t = a_t ⊙ h_{t−1} + x_t`` from h₀ = 0, one step at a time in the
    inputs' dtype: the JAX model's ``lax.scan`` (``recurrent_block``'s
    ``step``). a/x: [B, S, R] -> hs [B, S, R]."""
    h = torch.zeros_like(x[:, 0])
    hs = []
    for t in range(fold.steps(x.shape[1])):
        h = a[:, t] * h + x[:, t]
        hs.append(h)
    return torch.stack(fold.pad(hs, x.shape[1]), dim=1)


def recurrent_block(cfg, p, x, *, scan=ops.rglru):
    """Train/prefill. x: [B, S, D] -> (y [B, S, D], final state [B, R]).

    ``scan(a, x)`` runs the recurrence from a zero state:
    :func:`repro_torch.kernels.ops.rglru` unless the caller passes another
    (the training forward passes :func:`scan_steps`; ``chip_smoke.py``
    replays the model through the plain version on the card)."""
    dt = cfg.dtype
    gate = gelu(x @ p["w_in_g"].to(dt))
    u = x @ p["w_in_x"].to(dt)
    u = causal_conv1d(p, u, dt)
    a, gated_in = _gates(p, u, dt)
    hs = scan(a.contiguous(), gated_in.contiguous())      # [B, S, R]
    y = (hs * gate) @ p["w_out"].to(dt)
    return y, hs[:, -1]


def init_recurrent_state(cfg, batch: int, *, device, dtype=None):
    R = cfg.lru_width or cfg.d_model
    dt = dtype or cfg.dtype
    return {"h": torch.zeros((batch, R), dtype=dt, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, R), dtype=dt,
                                device=device)}


def recurrent_block_step(cfg, p, x_t, state):
    """Decode step. x_t: [B, 1, D] -> (y [B, 1, D], new state)."""
    dt = cfg.dtype
    gate = gelu(x_t @ p["w_in_g"].to(dt))
    u = x_t @ p["w_in_x"].to(dt)                              # [B, 1, R]
    hist = torch.cat([state["conv"], u], dim=1)               # [B, W, R]
    w = p["conv_w"].to(dt)
    u_conv = torch.einsum("bwr,wr->br", hist, w)[:, None, :] \
        + p["conv_b"].to(dt)
    a, gated_in = _gates(p, u_conv, dt)
    h = a[:, 0] * state["h"] + gated_in[:, 0]
    y = (h * gate[:, 0]) @ p["w_out"].to(dt)
    return y[:, None, :], {"h": h, "conv": hist[:, 1:]}
