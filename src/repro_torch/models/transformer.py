"""Dense decoder: parameter init, prefill and the decode cache.

* ``init_params(cfg, generator, device=)`` — dict tree with layer-stacked
  weights ``[L, ...]`` (the JAX package's tree, leaf for leaf);
* ``prefill(cfg, params, tokens, capacity)`` — full-prompt forward that also
  materializes the decode cache;
* ``init_cache(cfg, batch, capacity, device=)`` — an empty cache;
* ``decode_step(cfg, params, tokens, cache)`` — one token per slot against
  that cache (the speculative draft's step).

The JAX package scans over the stacked layers; here a Python loop walks them
(:func:`layer_params` gives layer ``i``'s views). Only the ``dense`` family
is ported; the others raise ``NotImplementedError`` (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (decode_self_attention, init_attn,
                                         init_kv_cache, qkv, sdpa)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, dense, embed, init_embed,
                                       init_mlp, make_norm_params, mlp, rope,
                                       unembed)

Params = Any


def require_dense(cfg: ModelConfig) -> None:
    """Reject configs the port cannot run yet: it has the dense
    full-attention family with RMSNorm, SwiGLU, no QKV bias and no logit
    soft-capping (``smollm-360m``)."""
    if (cfg.family, cfg.window, cfg.norm, cfg.act, cfg.qkv_bias,
            cfg.logits_softcap) != ("dense", None, "rmsnorm", "swiglu",
                                    False, 0.0):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} window={cfg.window!r} "
            f"norm={cfg.norm!r} act={cfg.act!r} qkv_bias={cfg.qkv_bias} "
            f"logits_softcap={cfg.logits_softcap}: the port runs the dense "
            "RMSNorm/SwiGLU family only (ROADMAP.md, queue 1, remaining "
            "model families)")


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``. Same tree and scales as the JAX package's
    ``init_params``; the draws differ (tests carry JAX weights over with
    :func:`repro_torch.weights.params_from_jax` instead)."""
    require_dense(cfg)
    dev = resolve_device(device)
    gd = generator.device
    params = {"embed": init_embed(cfg, generator),
              "final_norm": make_norm_params(cfg, cfg.d_model, gd)}
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({"norm1": make_norm_params(cfg, cfg.d_model, gd),
                       "norm2": make_norm_params(cfg, cfg.d_model, gd),
                       "attn": init_attn(cfg, generator),
                       "mlp": init_mlp(cfg, generator)})
    params["layers"] = _stack(layers)
    return tree_to(params, device=dev)


def tree_to(tree: Params, **kw) -> Params:
    """``Tensor.to(**kw)`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also materializes the decode cache
# ---------------------------------------------------------------------------

def _attn_layer_kv(cfg, p, x, positions):
    """One decoder layer over the whole prompt; also returns its roped k/v."""
    hn = apply_norm(cfg, p["norm1"], x)
    q, k, v = qkv(cfg, p["attn"], hn)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = sdpa(q, k, v, q_positions=positions, k_positions=positions,
               causal=True, window=None)
    B, S = x.shape[:2]
    h = x + dense(p["attn"]["wo"], out.reshape(B, S, -1), cfg.dtype)
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h)), (k, v)


def _kv_to_cache(k, v, capacity):
    """Keep the trailing min(S, capacity) positions, zero-padded to
    ``capacity``."""
    S = k.shape[1]
    keep = min(S, capacity)
    k_t, v_t = k[:, S - keep:], v[:, S - keep:]
    if keep < capacity:
        pad = (0, 0, 0, 0, 0, capacity - keep)
        k_t = torch.nn.functional.pad(k_t, pad)
        v_t = torch.nn.functional.pad(v_t, pad)
    return k_t, v_t


def prefill(cfg: ModelConfig, params: Params, tokens, capacity: int, *,
            length: int | None = None):
    """tokens [B, S] -> (last-token logits [B, 1, V], decode cache).

    The cache is ``{"kv": {"k", "v"}: [L, B, capacity, Hkv, Dh], "idx"}``,
    laid out as :func:`init_cache` lays it out.

    ``length`` (≤ S) marks the prompt as right-padded: logits are taken at
    position ``length - 1`` and the cache resumes from position ``length``.
    Pad positions are causally masked, so the valid outputs are unchanged.
    """
    require_dense(cfg)
    B, S = tokens.shape
    x = embed(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    idx = S if length is None else int(length)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_layer_kv(cfg, layer_params(params["layers"], i), x,
                                   positions)
        k, v = _kv_to_cache(k, v, capacity)
        ks.append(k)
        vs.append(v)
    cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}, "idx": idx}
    x = apply_norm(cfg, params["final_norm"], x[:, idx - 1:idx])
    return unembed(cfg, params["embed"], x), cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               device: str | torch.device = "cuda") -> Params:
    """Empty decode cache ``{"kv": {"k", "v"}, "idx": 0}`` with k/v
    ``[L, batch, capacity, Hkv, Dh]`` in ``cfg.dtype``."""
    require_dense(cfg)
    kv = init_kv_cache(cfg, cfg.n_layers * batch, capacity,
                       device=resolve_device(device))
    return {"kv": {name: t.reshape(cfg.n_layers, batch, *t.shape[1:])
                   for name, t in kv.items()},
            "idx": 0}


# ---------------------------------------------------------------------------
# Decode: one token per slot against the dense cache
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: Params, tokens, cache):
    """tokens [B, 1] -> (logits [B, 1, V], cache).

    ``cache["idx"]`` is the absolute position of this token: one for the
    batch, or a ``[B]`` tensor, one per slot (the slot layout of
    :func:`repro_torch.serve.batch.init_slot_cache`). The K/V leaves are
    written in place; the returned cache holds them and ``idx + 1``.
    """
    require_dense(cfg)
    B = tokens.shape[0]
    x = embed(cfg, params["embed"], tokens)
    idx = torch.as_tensor(cache["idx"], dtype=torch.int32,
                          device=tokens.device).reshape(-1).expand(B)
    kv = cache["kv"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn = apply_norm(cfg, lp["norm1"], x)
        x = x + decode_self_attention(
            cfg, lp["attn"], hn, {"k": kv["k"][i], "v": kv["v"][i]}, idx)
        x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), {"kv": kv,
                                              "idx": cache["idx"] + 1}
