"""The decoder: parameter init, the training forward and loss, prefill and
the decode cache, for the dense, hybrid (RecurrentGemma) and ssm (RWKV-6)
families.

* ``init_params(cfg, generator, device=)`` — dict tree with layer-stacked
  weights (the JAX package's tree, leaf for leaf): ``layers`` ``[L, ...]``
  for dense and ssm; ``blocks`` (one entry per position of the block
  pattern, stacked over ``n_layers // len(pattern)`` blocks) and the list
  ``rem`` of trailing layers for hybrid;
* ``forward(cfg, params, tokens)`` and ``loss_fn(cfg, params, batch)`` —
  the full-sequence training path: logits (or the final hidden states) and
  the next-token cross-entropy, taken chunk by chunk (:func:`chunked_ce`);
* ``prefill(cfg, params, tokens, capacity)`` — full-prompt forward that also
  materializes the decode cache;
* ``init_cache(cfg, batch, capacity, device=)`` — an empty cache;
* ``decode_step(cfg, params, tokens, cache)`` — one token per slot against
  that cache.

The JAX package scans over the stacked layers; here a Python loop walks them
(:func:`layer_params` gives layer ``i``'s views). Prefill attention, the
prefill RG-LRU recurrence and every WKV recurrence (prefill and decode) go
through :mod:`repro_torch.kernels.ops`: the CUDA kernels on the card, their
plain versions on the CPU. Other families raise ``NotImplementedError``
(``ROADMAP.md``).

The training path launches none of those kernels, by the JAX package's own
design and not as a fallback: its ``forward`` attends through the einsum
``sdpa``, runs the RG-LRU as a ``lax.scan`` and WKV as ``_wkv_scan``, and
reaches no ``pallas_call``; and neither package has a derivative for the
kernels, which are forward-only. So :func:`forward` attends through
:func:`~repro_torch.models.attention.self_attention` and passes the model
modules' own recurrences (:func:`repro_torch.models.rglru.scan_steps`,
:func:`repro_torch.models.rwkv6.wkv_scan`), which ``torch.func.grad``,
``jvp`` and ``vmap`` all go through, as the bilevel trainer's
Hessian-vector products need. It reads the ``param_dtype`` leaves and casts
each weight at use, as the JAX model does, so the gradients reach the
parameters themselves (:func:`compute_params` is for serving only). The JAX
package's ``cfg.remat`` (``jax.checkpoint``) is a memory policy that leaves
the numbers unchanged; ``torch.utils.checkpoint`` does not compose with the
``torch.func`` transforms, so the port computes directly.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import rglru, rwkv6
from repro_torch.models.attention import (decode_self_attention, init_attn,
                                         init_kv_cache, prefill_attention,
                                         qkv, self_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, dense, embed, init_embed,
                                       init_mlp, make_norm_params, mlp, rope,
                                       unembed)

Params = Any
# parameter leaves the JAX package reads in f32 whatever cfg.dtype is
F32_LEAVES = ("lam", "w0")
FAMILIES = ("dense", "hybrid", "ssm")


def require_ported(cfg: ModelConfig) -> None:
    """Reject configs the port cannot run yet: it has the dense, hybrid and
    ssm families with RMSNorm, SwiGLU or GELU and no logit soft-capping; the
    dense family with or without QKV bias and with full or sliding-window
    attention (``cfg.window``; the hybrid family's local window is its
    own). That is ``smollm-360m``, ``qwen2.5-3b``, ``granite-8b``,
    ``minicpm-2b`` and their ``long_500k`` variants, ``recurrentgemma-2b``
    and ``rwkv6-1.6b``."""
    if (cfg.family not in FAMILIES
            or (cfg.window is not None and cfg.family != "dense")
            or cfg.norm != "rmsnorm" or cfg.act not in ("swiglu", "gelu")
            or cfg.logits_softcap
            or not set(cfg.block_pattern) <= {"rec", "attn"}):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} window={cfg.window!r} "
            f"norm={cfg.norm!r} act={cfg.act!r} qkv_bias={cfg.qkv_bias} "
            f"logits_softcap={cfg.logits_softcap} "
            f"block_pattern={cfg.block_pattern}: the port runs the dense, "
            "hybrid and ssm RMSNorm families only, a window on the dense "
            "family only (ROADMAP.md, queue 1, remaining model families)")


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` tree."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def unstack(layers: Params, n: int) -> list:
    """The ``n`` per-layer trees of a stacked ``[n, ...]`` tree, by one
    ``unbind`` per leaf: views, as :func:`layer_params` gives, but the
    derivative is one ``stack`` per leaf, where indexing layer by layer
    would scatter each layer's gradient into a zero tensor of the whole
    stack and sum ``n`` of them."""
    if isinstance(layers, dict):
        parts = {k: unstack(v, n) for k, v in layers.items()}
        return [{k: parts[k][i] for k in layers} for i in range(n)]
    return list(torch.unbind(layers))


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_layer(cfg: ModelConfig, gen: torch.Generator, kind: str) -> Params:
    gd = gen.device
    p = {"norm1": make_norm_params(cfg, cfg.d_model, gd),
         "norm2": make_norm_params(cfg, cfg.d_model, gd)}
    if kind == "rwkv":
        p["tm"] = rwkv6.init_time_mix(cfg, gen)
        p["cm"] = rwkv6.init_channel_mix(cfg, gen)
        return p
    if kind == "rec":
        p["rec"] = rglru.init_recurrent_block(cfg, gen)
    else:
        p["attn"] = init_attn(cfg, gen)
    p["mlp"] = init_mlp(cfg, gen)
    return p


def _hybrid_shape(cfg: ModelConfig) -> tuple[tuple[str, ...], int, int]:
    """(block pattern, stacked blocks, trailing ``rem`` layers)."""
    pat = cfg.block_pattern
    nb = cfg.n_layers // len(pat)
    return pat, nb, cfg.n_layers - nb * len(pat)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``. Same tree and scales as the JAX package's
    ``init_params``; the draws differ (tests carry JAX weights over with
    :func:`repro_torch.weights.params_from_jax` instead)."""
    require_ported(cfg)
    dev = resolve_device(device)
    gd = generator.device
    params = {"embed": init_embed(cfg, generator),
              "final_norm": make_norm_params(cfg, cfg.d_model, gd)}
    if cfg.family == "hybrid":
        pat, nb, rem = _hybrid_shape(cfg)
        params["blocks"] = {
            f"l{i}_{kind}": _stack([_init_layer(cfg, generator, kind)
                                    for _ in range(nb)])
            for i, kind in enumerate(pat)}
        params["rem"] = [_init_layer(cfg, generator, pat[i % len(pat)])
                         for i in range(rem)]
    else:
        kind = "rwkv" if cfg.family == "ssm" else "attn"
        params["layers"] = _stack([_init_layer(cfg, generator, kind)
                                   for _ in range(cfg.n_layers)])
    return tree_to(params, device=dev)


def tree_to(tree: Params, **kw) -> Params:
    """``Tensor.to(**kw)`` over every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, **kw) for v in tree]
    return tree.to(**kw)


def compute_params(cfg: ModelConfig, params: Params, device) -> Params:
    """``params`` on ``device`` as the model computes with them: every leaf
    cast once to ``cfg.dtype``, which the JAX package casts each weight to at
    every use, except the RG-LRU's ``lam`` and the RWKV decay's ``w0``,
    which it reads in f32 (the same arithmetic, once instead of per
    call)."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree.to(device=device, dtype=torch.float32
                       if name in F32_LEAVES else cfg.dtype)

    return walk(params)


def hybrid_layers(cfg: ModelConfig, params: Params, cache: Params):
    """The hybrid model's layers in order — every block's pattern, then the
    trailing ``rem`` layers — as ``(kind, layer params, layer cache)``; the
    cache entries are views into ``cache``'s stacked leaves (or ``None``
    when ``cache`` is)."""
    pat, nb, _ = _hybrid_shape(cfg)
    blocks = {key: unstack(lp, nb) for key, lp in params["blocks"].items()}
    for j in range(nb):
        for i, kind in enumerate(pat):
            key = f"l{i}_{kind}"
            yield (kind, blocks[key][j],
                   None if cache is None
                   else layer_params(cache["blocks"][key], j))
    for i, lp in enumerate(params["rem"]):
        yield (pat[i % len(pat)], lp,
               None if cache is None else cache["rem"][i])


def param_count(params: Params) -> int:
    return sum(t.numel() for t in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# Training forward: the full sequence, the JAX model's arithmetic
# ---------------------------------------------------------------------------

def _embed_rows(cfg, p, tokens):
    """The training path's embedding lookup: the table's rows for
    ``tokens``, as :func:`~repro_torch.models.layers.embed` gives them, by a
    one-hot product. Indexing's derivative scatter-adds each token's
    gradient into its row, in an order that is not fixed: under ``vmap``
    two CPU runs summed repeated tokens differently. The product sums them
    in a fixed order on every device, which keeps fused and per-step runs
    equal bit for bit. The rows themselves are exact: one product of 1 with
    the entry, the rest zeros (f32 matmuls without TF32, PyTorch's
    default)."""
    table = p["table"]
    vocab = torch.arange(table.shape[0], device=tokens.device)
    onehot = (tokens[..., None] == vocab).to(table.dtype)
    return (onehot @ table).to(cfg.dtype)


def _attn_layer(cfg, p, x, positions, *, window):
    h = x + self_attention(cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
                           positions, causal=True, window=window)
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h))


def _rec_layer(cfg, p, x):
    y, _ = rglru.recurrent_block(cfg, p["rec"],
                                 apply_norm(cfg, p["norm1"], x),
                                 scan=rglru.scan_steps)
    h = x + y
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h))


def forward(cfg: ModelConfig, params: Params, tokens, *,
            return_hidden: bool = False):
    """tokens [B, S] -> (logits [B, S, V], aux dict); with
    ``return_hidden=True`` the final-norm'd hidden states [B, S, D] instead
    of the logits (what :func:`chunked_ce` reads). ``aux`` stays empty: it
    holds the MoE family's losses, which the port does not run yet."""
    require_ported(cfg)
    x = _embed_rows(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if cfg.family == "ssm":
        for lp in unstack(params["layers"], cfg.n_layers):
            x, _ = _rwkv_layer(cfg, lp, x, wkv=rwkv6.wkv_scan)
    elif cfg.family == "hybrid":
        for kind, lp, _ in hybrid_layers(cfg, params, None):
            x = (_rec_layer(cfg, lp, x) if kind == "rec" else
                 _attn_layer(cfg, lp, x, positions, window=cfg.local_window))
    else:
        for lp in unstack(params["layers"], cfg.n_layers):
            x = _attn_layer(cfg, lp, x, positions, window=cfg.window)
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, {}
    return unembed(cfg, params["embed"], x), {}


def _hidden_states(cfg: ModelConfig, params: Params, batch):
    """Final-norm'd hidden states: :func:`forward` without the unembed."""
    return forward(cfg, params, batch["tokens"], return_hidden=True)


def chunked_ce(cfg: ModelConfig, params: Params, x, labels,
               chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without the whole ``[B, S, V]``
    logits: ``chunk`` positions at a time (all S when S is not a multiple
    of it), each chunk's logits in f32 — the embedding table and the hidden
    states widened, as the JAX package's ``preferred_element_type`` asks."""
    B, S, _ = x.shape
    table = params["embed"]["table"].float()
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        logits = x[:, c:c + chunk].float() @ table.T
        tgt = torch.gather(logits, -1, labels[:, c:c + chunk, None].long())
        total = total + torch.sum(torch.logsumexp(logits, dim=-1)
                                  - tgt[..., 0])
    return total / (B * S)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` (``{'tokens', 'labels'}``,
    each ``[B, S]``), chunked (:func:`chunked_ce`)."""
    x, _ = _hidden_states(cfg, params, batch)
    return chunked_ce(cfg, params, x, batch["labels"])


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also materializes the decode cache
# ---------------------------------------------------------------------------

def _attn_layer_kv(cfg, p, x, positions, *, window, attend):
    """One decoder layer over the whole prompt; also returns its roped k/v.
    The attention is :func:`~repro_torch.models.attention.prefill_attention`
    through ``attend``."""
    hn = apply_norm(cfg, p["norm1"], x)
    q, k, v = qkv(cfg, p["attn"], hn)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = prefill_attention(q, k, v, causal=True, window=window,
                            attend=attend)
    B, S = x.shape[:2]
    h = x + dense(p["attn"]["wo"], out.reshape(B, S, -1), cfg.dtype)
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h)), (k, v)


def _kv_to_cache(k, v, capacity, window=None):
    """Keep the trailing min(S, capacity) positions, zero-padded to
    ``capacity``; a full ring (``window == capacity``) is rolled so that
    absolute position p sits at slot ``p % capacity``."""
    S = k.shape[1]
    keep = min(S, capacity)
    k_t, v_t = k[:, S - keep:], v[:, S - keep:]
    if keep < capacity:
        pad = (0, 0, 0, 0, 0, capacity - keep)
        k_t = torch.nn.functional.pad(k_t, pad)
        v_t = torch.nn.functional.pad(v_t, pad)
    elif window is not None and capacity == window:
        shift = S % capacity
        k_t = torch.roll(k_t, shift, dims=1)
        v_t = torch.roll(v_t, shift, dims=1)
    return k_t, v_t


def _rec_layer_state(cfg, p, x, *, scan):
    """One recurrent layer over the whole prompt; also returns its decode
    state: the final RG-LRU state and the last ``conv1d_width - 1``
    pre-convolution inputs. A prompt shorter than that is left-padded with
    zeros, the inputs ``causal_conv1d`` pads it with; the JAX package keeps
    only the prompt's rows there (``repro/models/transformer.py:384``), so
    its decode breaks on such a prompt, and the port departs from it."""
    hn = apply_norm(cfg, p["norm1"], x)
    u = hn @ p["rec"]["w_in_x"].to(cfg.dtype)
    y, h_last = rglru.recurrent_block(cfg, p["rec"], hn, scan=scan)
    h = x + y
    h = h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h))
    keep = cfg.conv1d_width - 1
    conv = torch.nn.functional.pad(u[:, -keep:],
                                   (0, 0, max(keep - u.shape[1], 0), 0))
    return h, {"h": h_last, "conv": conv}


def _rwkv_layer(cfg, p, x, state=None, *, wkv):
    """One RWKV-6 layer: time-mix then channel-mix, each on the normed
    residual stream. ``state`` is the layer's ``{tm_shift, cm_shift, S}``
    (None for a prompt). Returns (x, the layer's new state)."""
    y, tm = rwkv6.time_mix(
        cfg, p["tm"], apply_norm(cfg, p["norm1"], x),
        None if state is None else {"shift": state["tm_shift"],
                                    "S": state["S"]}, wkv=wkv)
    x = x + y
    y, cm_shift = rwkv6.channel_mix(
        cfg, p["cm"], apply_norm(cfg, p["norm2"], x),
        None if state is None else state["cm_shift"])
    return x + y, {"tm_shift": tm["shift"], "cm_shift": cm_shift,
                   "S": tm["S"]}


def prefill(cfg: ModelConfig, params: Params, tokens, capacity: int, *,
            length: int | None = None, attend=ops.attention,
            scan=ops.rglru, wkv=ops.wkv6):
    """tokens [B, S] -> (last-token logits [B, 1, V], decode cache).

    The cache is laid out as :func:`init_cache` lays it out: dense
    ``{"kv": {"k", "v"}: [L, B, capacity, Hkv, Dh], "idx"}``; hybrid
    ``{"blocks", "rem", "idx"}``, whose attention layers keep a ring of
    ``min(capacity, local_window)`` positions and whose recurrent layers
    keep ``{"h", "conv"}``; ssm ``{"state": {"tm_shift", "cm_shift", "S"},
    "idx"}`` with a leading layer axis (``capacity`` unused). A dense config
    with ``window`` attends within it and keeps the trailing ``capacity``
    positions, as a ring (absolute position ``p`` at slot ``p % capacity``)
    when ``capacity == window``.

    ``length`` (≤ S, dense only) marks the prompt as right-padded: logits are
    taken at position ``length - 1`` and the cache resumes from position
    ``length``. Pad positions are causally masked, so the valid outputs are
    unchanged; a recurrent state would fold the pad tokens in, so the hybrid
    and ssm families refuse it, as the JAX package's docstring does.

    ``attend``, ``scan`` and ``wkv`` run the prefill attention (``[B, H, S,
    Dh]`` layout), the RG-LRU recurrence and the WKV recurrence: the
    kernels' dispatch in :mod:`repro_torch.kernels.ops` unless the caller
    passes the plain versions.
    """
    require_ported(cfg)
    B, S = tokens.shape
    x = embed(cfg, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    if cfg.family in ("hybrid", "ssm") and length is not None:
        raise ValueError(f"prefill(length=) pads the prompt, which the "
                         f"{cfg.family} family's recurrent state would "
                         "absorb")
    if cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            x, st = _rwkv_layer(cfg, layer_params(params["layers"], i), x,
                                wkv=wkv)
            states.append(st)
        cache = {"state": _stack(states), "idx": S}
        idx = S
    elif cfg.family == "hybrid":
        win = min(capacity, cfg.local_window)
        pat, nb, _ = _hybrid_shape(cfg)
        blocks = {f"l{i}_{kind}": [] for i, kind in enumerate(pat)}
        rem = []
        for n, (kind, lp, _) in enumerate(hybrid_layers(cfg, params, None)):
            if kind == "rec":
                x, st = _rec_layer_state(cfg, lp, x, scan=scan)
            else:
                x, (k, v) = _attn_layer_kv(cfg, lp, x, positions, window=win,
                                           attend=attend)
                k, v = _kv_to_cache(k, v, win, win)
                st = {"k": k, "v": v}
            if n < nb * len(pat):
                blocks[f"l{n % len(pat)}_{kind}"].append(st)
            else:
                rem.append(st)
        cache = {"blocks": {key: _stack(sts) for key, sts in blocks.items()},
                 "rem": rem, "idx": S}
        idx = S
    else:
        idx = S if length is None else int(length)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, (k, v) = _attn_layer_kv(cfg, layer_params(params["layers"], i),
                                       x, positions, window=cfg.window,
                                       attend=attend)
            k, v = _kv_to_cache(k, v, capacity, cfg.window)
            ks.append(k)
            vs.append(v)
        cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "idx": idx}
    x = apply_norm(cfg, params["final_norm"], x[:, idx - 1:idx])
    return unembed(cfg, params["embed"], x), cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               device: str | torch.device = "cuda") -> Params:
    """Empty decode cache in ``cfg.dtype``: dense ``{"kv": {"k", "v"},
    "idx": 0}`` with k/v ``[L, batch, capacity, Hkv, Dh]``; hybrid
    ``{"blocks", "rem", "idx": 0}`` with each block leaf stacked ``[n_blocks,
    batch, ...]``: attention rings k/v ``[batch, min(capacity,
    local_window), Hkv, Dh]``, recurrent state h ``[batch, R]`` and conv
    ``[batch, conv1d_width - 1, R]``; ssm ``{"state", "idx": 0}`` with
    ``tm_shift``/``cm_shift`` ``[L, batch, D]`` and S ``[L, batch, H, Dh,
    Dh]`` in f32 (``capacity`` unused)."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        st = rwkv6.init_rwkv_state(cfg, cfg.n_layers * batch, device=dev)
        return {"state": {k: t.reshape(cfg.n_layers, batch, *t.shape[1:])
                          for k, t in st.items()},
                "idx": 0}
    if cfg.family == "hybrid":
        pat, nb, rem = _hybrid_shape(cfg)
        win = min(capacity, cfg.local_window)

        def state(kind, n):
            if kind == "rec":
                st = rglru.init_recurrent_state(cfg, n * batch, device=dev)
            else:
                st = init_kv_cache(cfg, n * batch, win, device=dev)
            return {k: t.reshape(n, batch, *t.shape[1:])
                    for k, t in st.items()}

        return {"blocks": {f"l{i}_{kind}": state(kind, nb)
                           for i, kind in enumerate(pat)},
                "rem": [{k: t[0] for k, t in
                         state(pat[i % len(pat)], 1).items()}
                        for i in range(rem)],
                "idx": 0}
    kv = init_kv_cache(cfg, cfg.n_layers * batch, capacity, device=dev)
    return {"kv": {name: t.reshape(cfg.n_layers, batch, *t.shape[1:])
                   for name, t in kv.items()},
            "idx": 0}


# ---------------------------------------------------------------------------
# Decode: one token per slot against the dense cache
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: Params, tokens, cache, *,
                wkv=ops.wkv6):
    """tokens [B, 1] -> (logits [B, 1, V], cache).

    ``cache["idx"]`` is the absolute position of this token: one for the
    batch, or a ``[B]`` tensor, one per slot (the slot layout of
    :func:`repro_torch.serve.batch.init_slot_cache`). Every cache leaf is
    written in place; the returned cache holds them and ``idx + 1``. The
    hybrid family's attention layers, and a dense config with ``window``,
    write their rings at ``idx % capacity``; the ssm family's WKV step runs
    through ``wkv`` (the kernels' dispatch unless the caller passes the
    plain version).
    """
    require_ported(cfg)
    B = tokens.shape[0]
    x = embed(cfg, params["embed"], tokens)
    idx = torch.as_tensor(cache["idx"], dtype=torch.int32,
                          device=tokens.device).reshape(-1).expand(B)
    if cfg.family == "ssm":
        state = cache["state"]
        for i in range(cfg.n_layers):
            x, new = _rwkv_layer(cfg, layer_params(params["layers"], i), x,
                                 layer_params(state, i), wkv=wkv)
            for name, t in new.items():
                state[name][i].copy_(t)
        new_cache = {"state": state}
    elif cfg.family == "hybrid":
        for kind, lp, st in hybrid_layers(cfg, params, cache):
            hn = apply_norm(cfg, lp["norm1"], x)
            if kind == "rec":
                y, new = rglru.recurrent_block_step(cfg, lp["rec"], hn, st)
                for name, t in new.items():
                    st[name].copy_(t)
            else:
                y = decode_self_attention(cfg, lp["attn"], hn, st, idx,
                                          window=cfg.local_window)
            x = x + y
            x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], x))
        new_cache = {"blocks": cache["blocks"], "rem": cache["rem"]}
    else:
        kv = cache["kv"]
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            hn = apply_norm(cfg, lp["norm1"], x)
            x = x + decode_self_attention(
                cfg, lp["attn"], hn, {"k": kv["k"][i], "v": kv["v"][i]}, idx,
                window=cfg.window)
            x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm2"], x))
        new_cache = {"kv": kv}
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), {**new_cache,
                                              "idx": cache["idx"] + 1}
