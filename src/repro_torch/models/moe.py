"""Top-k routed Mixture-of-Experts with capacity-based scatter dispatch, the
JAX package's ``repro.models.moe`` step by step.

Tokens are split into groups, each with its own expert capacity ``C``.
Position-in-expert comes from a cumulative sum over the token-major
flattened (token, choice) assignments; assignments past an expert's
capacity are dropped (they scatter to one overflow row, which is
discarded). The expert products are batched matmuls over the expert axis,
which the JAX package also computes outside any Pallas kernel.

Two groupings, as the reference's two kinds of call give them:

* joint (``per_token=False``): ``cfg.moe_groups`` groups over all the
  batch's tokens (one group when they do not divide evenly) — a prefill,
  the cohort drain's decode, a serial ``decode_step`` on a ``[B, 1]``
  batch;
* per token (``per_token=True``): every token is a group of its own, so a
  slot's routing never sees its neighbours' — the reference vmaps
  ``moe_mlp`` over slots (and verify-window rows), each a batch of one
  token. The slot decode, the paged decode and the verify window route so.

Every step runs under ``torch.func.vmap``, ``grad`` and ``jvp``, as the
bilevel trainer's per-node gradients and Hessian-vector products need: the
one-hots are comparisons with ``arange(E)`` and the dispatch writes out of
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


def init_moe(cfg, gen: torch.Generator):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pd, dev = cfg.param_dtype, gen.device
    return {
        "router": init_dense(gen, D, E, pd)["w"],
        "wi": (torch.randn((E, D, Fd), generator=gen, device=dev)
               * D ** -0.5).to(pd),
        "wg": (torch.randn((E, D, Fd), generator=gen, device=dev)
               * D ** -0.5).to(pd),
        "wo": (torch.randn((E, Fd, D), generator=gen, device=dev)
               * Fd ** -0.5).to(pd),
    }


def _one_hot(idx, E: int):
    """``idx`` [...] -> bool [..., E]: a comparison with ``arange(E)``, the
    values of ``F.one_hot``, which checks its range with a host read that
    ``torch.func.vmap`` cannot take."""
    return idx[..., None] == torch.arange(E, device=idx.device)


def route(cfg, p, flat):
    """Routing of ``flat`` [G, n, D] (G groups of n tokens): a dict of
    ``logits``/``probs`` [G, n, E] (f32), ``top_w``/``top_e`` [G, n, K]
    (renormalised weights, experts in descending probability, ties to the
    lower index as ``jax.lax.top_k`` breaks them), ``pos`` [G, n*K]
    (position in the expert, token-major), ``keep`` [G, n*K] and ``dest``
    [G, n*K] (row of the ``[E*C + 1]`` dispatch buffer; ``E*C`` is the
    overflow row), and the capacity ``C``."""
    G, n, _ = flat.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first among equal
    # probabilities
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    # per-group capacity
    C = max(int(cfg.capacity_factor * n * K / E + 0.999), 4)
    assign = top_e.reshape(G, n * K)
    onehot = _one_hot(assign, E).to(torch.int32)
    pos = torch.sum((torch.cumsum(onehot, dim=1) - 1) * onehot, dim=-1)
    keep = pos < C
    dest = torch.where(keep, assign * C + pos, E * C)
    return {"logits": logits, "probs": probs, "top_w": top_w,
            "top_e": top_e, "pos": pos, "keep": keep, "dest": dest, "C": C}


def combine(r, expert_out):
    """The combine: each (token, choice) assignment's expert output row
    gathered back (zeros for a dropped one) and weighted by its routing
    weight in the output's dtype, summed over the K choices. ``r``:
    :func:`route`'s dict; expert_out [E, G, C, D] -> [G, n, D]."""
    E, G, C, D = expert_out.shape
    n, K = r["top_e"].shape[1:]
    dt = expert_out.dtype
    back = expert_out.transpose(0, 1).reshape(G, E * C, D)
    padded = torch.cat([back, torch.zeros((G, 1, D), dtype=dt,
                                          device=back.device)], dim=1)
    groups = torch.arange(G, device=back.device)[:, None]
    gathered = padded[groups, r["dest"]]                        # [G, n*K, D]
    weights = (r["top_w"].reshape(G, n * K) * r["keep"]).to(dt)
    return torch.sum((gathered * weights[..., None]).reshape(G, n, K, D),
                     dim=2)


def moe_mlp(cfg, p, x, *, per_token: bool = False):
    """x: [B, S, D] -> (out [B, S, D], aux losses ``{"moe_lb", "moe_z"}``).

    ``per_token`` makes every token its own group of one (see the module's
    docstring); otherwise ``cfg.moe_groups`` groups, or one when they do not
    divide ``B * S``."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    if per_token:
        G = N
    else:
        G = max(int(cfg.moe_groups), 1)
        if N % G:
            G = 1
    n = N // G
    flat = x.reshape(G, n, D)
    r = route(cfg, p, flat)
    C, dest = r["C"], r["dest"]

    # dispatch: each kept assignment to its own row; dropped ones all land
    # on the overflow row E*C, which is discarded. Out of place, so that
    # vmap can write a node's batched rows into the unbatched zeros.
    rep = torch.repeat_interleave(flat, K, dim=1)               # [G, n*K, D]
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
    groups = torch.arange(G, device=x.device)[:, None]
    buf = buf.index_put((groups, dest), rep)
    expert_in = buf[:, :E * C].reshape(G, E, C, D).transpose(0, 1)

    # the SwiGLU expert FFN, batched over the expert axis
    dt = x.dtype
    xe = expert_in.reshape(E, G * C, D)
    h = F.silu(torch.bmm(xe, p["wg"].to(dt))) * torch.bmm(xe, p["wi"].to(dt))
    expert_out = torch.bmm(h, p["wo"].to(dt)).reshape(E, G, C, D)

    out = combine(r, expert_out)

    # aux losses: Switch-style load balance and the router z-loss
    frac_tokens = torch.mean(_one_hot(r["top_e"][..., 0], E).float(),
                             dim=(0, 1))
    frac_probs = torch.mean(r["probs"], dim=(0, 1))
    aux_lb = E * torch.sum(frac_tokens * frac_probs)
    z_loss = torch.mean(torch.logsumexp(r["logits"], dim=-1) ** 2)
    return out.reshape(B, S, D), {"moe_lb": aux_lb, "moe_z": z_loss}
