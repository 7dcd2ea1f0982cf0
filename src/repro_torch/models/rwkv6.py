"""RWKV-6 "Finch" blocks: time-mix with data-dependent decay, and
channel-mix (arXiv:2404.05892).

The counterpart of ``repro.models.rwkv6``, cast for cast: token-shift
interpolation, a LoRA-parameterised decay ``w_t``, and a per-head state
matrix

    y_t = r_t · (S_t + (u ⊙ k_t) v_tᵀ)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

carried in f32. Decode keeps O(1) state (no KV cache): the two token
shifts and S. Every call of :func:`time_mix`, a prefill over the prompt or
one decode step, runs the recurrence through ``wkv`` — by default
:func:`repro_torch.kernels.ops.wkv6`, the CUDA kernel on the card and the
plain version on the CPU. The training forward passes :func:`wkv_scan`, the
JAX model's own ``_wkv_scan``, which every ``torch.func`` transform can
differentiate (the kernel has no derivative in either package).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import fold
from repro_torch.kernels import ops
from repro_torch.models.layers import init_dense

LORA_R = 64


def init_time_mix(cfg, gen: torch.Generator):
    """Same tree and scales as the JAX package's; the draws differ."""
    D = cfg.d_model
    pd = cfg.param_dtype
    dev = gen.device

    def half():
        return 0.5 * torch.ones((D,), dtype=pd, device=dev)

    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "w_r": init_dense(gen, D, D, pd)["w"],
        "w_k": init_dense(gen, D, D, pd)["w"],
        "w_v": init_dense(gen, D, D, pd)["w"],
        "w_g": init_dense(gen, D, D, pd)["w"],
        "w_o": init_dense(gen, D, D, pd, scale=D ** -0.5)["w"],
        # decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((D,), -6.0, dtype=pd, device=dev),
        "wA": init_dense(gen, D, LORA_R, pd)["w"],
        "wB": (torch.randn((LORA_R, D), generator=gen, device=dev)
               * 0.01).to(pd),
        "u": (torch.randn((D,), generator=gen, device=dev) * 0.1).to(pd),
        "ln_scale": torch.ones((D,), dtype=pd, device=dev),
    }


def _shift(x, prev=None):
    """x_{t-1} along the sequence axis; ``prev`` seeds position 0
    (decode), zeros otherwise."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _project(cfg, p, x, xprev):
    """(r, k, v, g in ``cfg.dtype``, the decay w in f32)."""
    dt = cfg.dtype

    def tmix(mu):
        return x + mu.to(dt) * (xprev - x)

    r = tmix(p["mu_r"]) @ p["w_r"].to(dt)
    k = tmix(p["mu_k"]) @ p["w_k"].to(dt)
    v = tmix(p["mu_v"]) @ p["w_v"].to(dt)
    g = tmix(p["mu_g"]) @ p["w_g"].to(dt)
    lora = torch.tanh(tmix(p["mu_w"]) @ p["wA"].to(dt)) @ p["wB"].to(dt)
    logw = -torch.exp(torch.clamp(p["w0"].float() + lora.float(), -20.0,
                                  1.0))
    return r, k, v, g, torch.exp(logw)     # decay in (0, 1)


def _heads(cfg, t):
    B, S, D = t.shape
    H = cfg.n_heads
    return t.reshape(B, S, H, D // H)


def wkv_scan(r, k, v, w, u, s0=None):
    """The JAX model's sequential WKV recurrence (``_wkv_scan``), in f32.
    r/k/v [B, S, H, Dh] (widened to f32 here, as the JAX model widens them);
    w [B, S, H, Dh] f32 decay; u [H, Dh] f32 bonus; s0 [B, H, Dh, Dh] f32 or
    None (zeros). Returns (y [B, S, H, Dh] in r's dtype, S_T) — the contract
    of ``time_mix``'s ``wkv``."""
    dt = r.dtype
    r, k, v = r.float(), k.float(), v.float()
    B, S, H, Dh = r.shape
    state = (torch.zeros((B, H, Dh, Dh), dtype=torch.float32,
                         device=r.device) if s0 is None else s0)
    ys = []
    for t in range(fold.steps(S)):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, Dh, Dh]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(fold.pad(ys, S), dim=1).to(dt), state


def time_mix(cfg, p, x, state=None, *, wkv=ops.wkv6):
    """x: [B, S, D] -> (y [B, S, D], new state ``{"shift": [B, D], "S":
    [B, H, Dh, Dh] f32}``); ``state`` (None for a prompt) seeds the shift
    and the recurrence. ``wkv(r, k, v, w, u, s0)`` runs the recurrence:
    r/k/v in ``cfg.dtype`` (the JAX model widens them to f32, which the
    kernel does as it reads them), the decay rounded to ``cfg.dtype`` and
    widened, u rounded likewise; y comes back in ``cfg.dtype``, rounded
    once as the JAX model rounds it after the head merge."""
    dt = cfg.dtype
    B, S, D = x.shape
    H = cfg.n_heads
    xprev = _shift(x, None if state is None else state["shift"])
    r, k, v, g, w = _project(cfg, p, x, xprev)
    u = p["u"].to(dt).float().reshape(H, D // H)
    y, s_t = wkv(_heads(cfg, r), _heads(cfg, k), _heads(cfg, v),
                 _heads(cfg, w.to(dt)).float(), u,
                 None if state is None else state["S"])
    y = y.reshape(B, S, D)
    # per-head group norm approximated by rms over channels
    y = y * torch.rsqrt(torch.mean(y.float() ** 2, dim=-1, keepdim=True)
                        + 1e-6).to(dt)
    y = y * p["ln_scale"].to(dt)
    y = y * F.silu(g)
    return y @ p["w_o"].to(dt), {"shift": x[:, -1, :], "S": s_t}


def init_channel_mix(cfg, gen: torch.Generator):
    D, Fd = cfg.d_model, cfg.d_ff
    pd = cfg.param_dtype
    return {
        "mu_k": 0.5 * torch.ones((D,), dtype=pd, device=gen.device),
        "mu_r": 0.5 * torch.ones((D,), dtype=pd, device=gen.device),
        "w_k": init_dense(gen, D, Fd, pd)["w"],
        "w_v": init_dense(gen, Fd, D, pd, scale=Fd ** -0.5)["w"],
        "w_r": init_dense(gen, D, D, pd)["w"],
    }


def channel_mix(cfg, p, x, state=None):
    """x: [B, S, D] -> (y [B, S, D], the new shift [B, D])."""
    dt = cfg.dtype
    xprev = _shift(x, state)
    xk = x + p["mu_k"].to(dt) * (xprev - x)
    xr = x + p["mu_r"].to(dt) * (xprev - x)
    k = torch.square(torch.relu(xk @ p["w_k"].to(dt)))
    kv = k @ p["w_v"].to(dt)
    r = torch.sigmoid(xr @ p["w_r"].to(dt))
    return r * kv, x[:, -1, :]


def init_rwkv_state(cfg, batch: int, *, device):
    """Zero decode state: both token shifts in ``cfg.dtype``, S in f32."""
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    return {
        "tm_shift": torch.zeros((batch, D), dtype=cfg.dtype, device=device),
        "cm_shift": torch.zeros((batch, D), dtype=cfg.dtype, device=device),
        "S": torch.zeros((batch, H, Dh, Dh), dtype=torch.float32,
                         device=device),
    }
