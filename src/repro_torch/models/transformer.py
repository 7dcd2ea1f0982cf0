"""The model: parameter init, the training forward and loss, prefill and
the decode cache, for every family of the JAX package: dense, moe, hybrid
(RecurrentGemma), ssm (RWKV-6), vlm (early fusion of image embeddings) and
audio (Whisper's encoder-decoder).

* ``init_params(cfg, generator, device=)`` — dict tree with layer-stacked
  weights (the JAX package's tree, leaf for leaf): ``layers`` ``[L, ...]``
  for dense, moe, vlm and ssm (a moe layer holds ``moe`` in place of
  ``mlp``); ``blocks`` (one entry per position of the block pattern,
  stacked over ``n_layers // len(pattern)`` blocks) and the list ``rem`` of
  trailing layers for hybrid; ``enc_layers``, ``enc_norm`` and the decoder
  ``layers`` (self-attention, ``cross``-attention, three norms) for
  audio;
* ``forward(cfg, params, tokens, *, image_embeds=, image_pos=,
  src_embeds=)`` and ``loss_fn(cfg, params, batch)`` — the full-sequence
  training path: logits (or the final hidden states) with the MoE aux
  losses, and the next-token cross-entropy taken chunk by chunk
  (:func:`chunked_ce`) plus those aux losses;
* ``prefill(cfg, params, tokens, capacity)`` — full-prompt forward that also
  materializes the decode cache;
* ``init_cache(cfg, batch, capacity, device=)`` — an empty cache (audio:
  with the cross-attention K/V of its encoded ``src_embeds``);
* ``cache_batch_axes`` / ``cache_capacity_axes`` — each cache leaf's batch
  and capacity axis, found by building ``init_cache`` on the ``meta``
  device at two sizes, as the JAX package finds them by ``eval_shape``;
* ``decode_step(cfg, params, tokens, cache)`` — one token per slot against
  that cache.

The JAX package scans over the stacked layers; here a Python loop walks them
(:func:`layer_params` gives layer ``i``'s views). Every prefill attention
(the decoder's, whisper's encoder and its cross-attention over the encoder),
the prefill RG-LRU recurrence and every WKV recurrence (prefill and decode)
go through :mod:`repro_torch.kernels.ops`: the CUDA kernels on the card,
their plain versions on the CPU. Decode attends through the einsum ``sdpa``,
as the reference does.

The MoE family routes jointly in a prefill and in a ``decode_step`` on a
batch, as the reference's calls do; ``decode_step(moe_per_token=True)``
gives each slot its own routing group, as the reference's vmap over slots
gives it (:mod:`repro_torch.models.moe`).

The training path (every family) launches none of those kernels, by the
JAX package's own design and not as a fallback: its ``forward`` attends
through the einsum ``sdpa`` (whisper's encoder and cross-attention too),
runs the RG-LRU as a ``lax.scan``, WKV as ``_wkv_scan`` and the MoE experts
as ``einsum``s, and reaches no ``pallas_call``; and neither package has a
derivative for the kernels, which are forward-only. So :func:`forward`
attends through :func:`~repro_torch.models.attention.self_attention` and
:func:`~repro_torch.models.attention.cross_attention` (the encoder through
:func:`_einsum_attend`) and passes the model modules' own recurrences
(:func:`repro_torch.models.rglru.scan_steps`,
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
from repro_torch.models import moe, rglru, rwkv6
from repro_torch.models.attention import (cross_attention,
                                         decode_self_attention, init_attn,
                                         init_kv_cache, kv_proj,
                                         prefill_attention, qkv, sdpa,
                                         self_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, dense, embed, init_embed,
                                       init_mlp, make_norm_params, mlp, rope,
                                       softcap, unembed)

Params = Any
# parameter leaves the JAX package reads in f32 whatever cfg.dtype is
F32_LEAVES = ("lam", "w0")
FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
# the decoder-only families whose cache is one stacked KV tree
KV_FAMILIES = ("dense", "vlm", "moe")
# the families whose attention layers read ``cfg.window`` (audio: its
# decoder's self-attention); the hybrid family reads ``local_window`` and
# the ssm family has no attention
WINDOW_FAMILIES = KV_FAMILIES + ("audio",)


def require_ported(cfg: ModelConfig) -> None:
    """Reject what the port cannot run: a family, norm, activation or block
    kind the JAX package does not have either, or a sliding ``window`` on
    the hybrid or ssm family, whose layers never read it (the hybrid
    family's local window is ``local_window``)."""
    if (cfg.family not in FAMILIES
            or (cfg.window is not None
                and cfg.family not in WINDOW_FAMILIES)
            or cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.act not in ("swiglu", "gelu")
            or not set(cfg.block_pattern) <= {"rec", "attn"}):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} window={cfg.window!r} "
            f"norm={cfg.norm!r} act={cfg.act!r} "
            f"block_pattern={cfg.block_pattern}: the port takes a window on "
            f"the {', '.join(WINDOW_FAMILIES)} families only")


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
    if kind == "moe":
        p["moe"] = moe.init_moe(cfg, gen)
        return p
    if kind == "encdec":
        p["cross"] = init_attn(cfg, gen)
        p["norm3"] = make_norm_params(cfg, cfg.d_model, gd)
    p["mlp"] = init_mlp(cfg, gen)
    return p


def _layer_kind(cfg: ModelConfig) -> str:
    return {"dense": "attn", "vlm": "attn", "moe": "moe", "ssm": "rwkv",
            "audio": "encdec"}[cfg.family]


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
        if cfg.family == "audio":
            params["enc_layers"] = _stack([
                _init_layer(cfg, generator, "attn")
                for _ in range(cfg.n_enc_layers)])
            params["enc_norm"] = make_norm_params(cfg, cfg.d_model, gd)
        params["layers"] = _stack([_init_layer(cfg, generator,
                                               _layer_kind(cfg))
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
    """One causal attention layer over the whole sequence: (x, the MoE
    layer's aux losses, or ``{}`` for an MLP layer). The MoE layer routes
    jointly (``cfg.moe_groups`` groups), as the JAX model's does."""
    h = x + self_attention(cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
                           positions, causal=True, window=window)
    if "moe" in p:
        out, aux = moe.moe_mlp(cfg, p["moe"], apply_norm(cfg, p["norm2"], h))
        return h + out, aux
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h)), {}


def _rec_layer(cfg, p, x):
    y, _ = rglru.recurrent_block(cfg, p["rec"],
                                 apply_norm(cfg, p["norm1"], x),
                                 scan=rglru.scan_steps)
    h = x + y
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], h))


def _encdec_layer(cfg, p, x, enc, positions):
    """One Whisper decoder layer over the whole sequence: causal
    self-attention (within ``cfg.window``), cross-attention over the
    encoder's output ``enc``, the MLP."""
    h = x + self_attention(cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
                           positions, causal=True, window=cfg.window)
    h = h + cross_attention(cfg, p["cross"], apply_norm(cfg, p["norm2"], h),
                            kv_x=enc)
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm3"], h))


def _einsum_attend(q, k, v, *, causal, window):
    """The einsum :func:`~repro_torch.models.attention.sdpa` in the
    kernels' ``[B, H, S, Dh]`` layout at positions 0 .. S-1: the attention
    the training path hands :func:`_encode`."""
    qpos = torch.arange(q.shape[2], device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               q_positions=qpos, k_positions=kpos, causal=causal,
               window=window)
    return out.transpose(1, 2)


def forward(cfg: ModelConfig, params: Params, tokens, *, image_embeds=None,
            image_pos=None, src_embeds=None, return_hidden: bool = False):
    """tokens [B, S] -> (logits [B, S, V], aux dict); with
    ``return_hidden=True`` the final-norm'd hidden states [B, S, D] instead
    of the logits (what :func:`chunked_ce` reads). ``aux`` holds the MoE
    family's ``moe_lb`` and ``moe_z``, each summed over the layers, and is
    empty for the other families.

    vlm: ``image_embeds`` [B, n, D] replace the token embeddings at
    ``image_pos`` [B, n] before the first layer. audio: ``src_embeds`` [B,
    src_len, D] run through the encoder, which every decoder layer
    cross-attends."""
    require_ported(cfg)
    x = _embed_rows(cfg, params["embed"], tokens)
    if cfg.family == "vlm" and image_embeds is not None:
        x = _merge_image_embeds(x, image_embeds, image_pos)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = {}
    if cfg.family == "ssm":
        for lp in unstack(params["layers"], cfg.n_layers):
            x, _ = _rwkv_layer(cfg, lp, x, wkv=rwkv6.wkv_scan)
    elif cfg.family == "hybrid":
        for kind, lp, _ in hybrid_layers(cfg, params, None):
            x = (_rec_layer(cfg, lp, x) if kind == "rec" else
                 _attn_layer(cfg, lp, x, positions,
                             window=cfg.local_window)[0])
    elif cfg.family == "audio":
        if src_embeds is None:
            raise ValueError("the audio family's forward needs src_embeds")
        enc = _encode(cfg, params, src_embeds, attend=_einsum_attend)
        for lp in unstack(params["layers"], cfg.n_layers):
            x = _encdec_layer(cfg, lp, x, enc, positions)
    else:
        auxs = []
        for lp in unstack(params["layers"], cfg.n_layers):
            x, a = _attn_layer(cfg, lp, x, positions, window=cfg.window)
            auxs.append(a)
        aux = {k: torch.sum(torch.stack([a[k] for a in auxs]))
               for k in auxs[0]}
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x, aux
    return unembed(cfg, params["embed"], x), aux


def _hidden_states(cfg: ModelConfig, params: Params, batch):
    """Final-norm'd hidden states and the aux losses: :func:`forward`
    without the unembed, on the batch's tokens and its modality extras."""
    return forward(cfg, params, batch["tokens"],
                   image_embeds=batch.get("image_embeds"),
                   image_pos=batch.get("image_pos"),
                   src_embeds=batch.get("src_embeds"), return_hidden=True)


def chunked_ce(cfg: ModelConfig, params: Params, x, labels,
               chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without the whole ``[B, S, V]``
    logits: ``chunk`` positions at a time (all S when S is not a multiple
    of it), each chunk's logits in f32 — the embedding table and the hidden
    states widened, as the JAX package's ``preferred_element_type`` asks —
    soft-capped as :func:`~repro_torch.models.layers.unembed` caps them."""
    B, S, _ = x.shape
    table = params["embed"]["table"].float()
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        logits = softcap(cfg, x[:, c:c + chunk].float() @ table.T)
        tgt = torch.gather(logits, -1, labels[:, c:c + chunk, None].long())
        total = total + torch.sum(torch.logsumexp(logits, dim=-1)
                                  - tgt[..., 0])
    return total / (B * S)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` (``{'tokens', 'labels'}``,
    each ``[B, S]``, and the vlm or audio extras), chunked
    (:func:`chunked_ce`), plus ``0.01 moe_lb + 0.001 moe_z`` for the MoE
    family."""
    x, aux = _hidden_states(cfg, params, batch)
    loss = chunked_ce(cfg, params, x, batch["labels"])
    if "moe_lb" in aux:
        loss = loss + 0.01 * aux["moe_lb"] + 0.001 * aux["moe_z"]
    return loss


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also materializes the decode cache
# ---------------------------------------------------------------------------

def ffn(cfg, p, hn, *, moe_per_token: bool = False):
    """A layer's feed-forward block on its normed input: the MLP, or the
    MoE layer (routed per token with ``moe_per_token``, else jointly)."""
    if "moe" in p:
        return moe.moe_mlp(cfg, p["moe"], hn, per_token=moe_per_token)[0]
    return mlp(cfg, p["mlp"], hn)


def _self_attn_kv(cfg, p, x, positions, *, window, attend, causal=True):
    """The residual stream after one layer's self-attention over the whole
    sequence, and the layer's roped k/v. The attention is
    :func:`~repro_torch.models.attention.prefill_attention` through
    ``attend``."""
    hn = apply_norm(cfg, p["norm1"], x)
    q, k, v = qkv(cfg, p["attn"], hn)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = prefill_attention(q, k, v, causal=causal, window=window,
                            attend=attend)
    B, S = x.shape[:2]
    return x + dense(p["attn"]["wo"], out.reshape(B, S, -1), cfg.dtype), \
        (k, v)


def _attn_layer_kv(cfg, p, x, positions, *, window, attend, causal=True):
    """One decoder (or, non-causal, encoder) layer over the whole sequence;
    also returns its roped k/v."""
    h, kv = _self_attn_kv(cfg, p, x, positions, window=window,
                          attend=attend, causal=causal)
    return h + ffn(cfg, p, apply_norm(cfg, p["norm2"], h)), kv


def _encdec_layer_kv(cfg, p, x, enc, positions, *, attend):
    """One Whisper decoder layer over the whole prompt: causal
    self-attention, cross-attention over the encoder's output ``enc``, the
    MLP. Returns (x, its self-attention k/v, its cross-attention k/v)."""
    h, kv = _self_attn_kv(cfg, p, x, positions, window=cfg.window,
                          attend=attend)
    ck, cv = kv_proj(cfg, p["cross"], enc)
    h = h + cross_attention(cfg, p["cross"], apply_norm(cfg, p["norm2"], h),
                            kv_cache={"k": ck, "v": cv}, attend=attend)
    return h + mlp(cfg, p["mlp"], apply_norm(cfg, p["norm3"], h)), kv, \
        (ck, cv)


def _merge_image_embeds(x, image_embeds, image_pos):
    """Early fusion: row ``b``'s embeddings at ``image_pos[b]`` are replaced
    by ``image_embeds[b]`` (cast to x's dtype)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x.index_put((rows, image_pos.long()), image_embeds.to(x.dtype))


def _encode(cfg, params, src_embeds, *, attend):
    """Whisper's encoder: non-causal self-attention layers over the source
    frames at positions 0 .. src_len - 1, then its final norm."""
    x = src_embeds.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in unstack(params["enc_layers"], cfg.n_enc_layers):
        x, _ = _attn_layer_kv(cfg, lp, x, positions, window=None,
                              attend=attend, causal=False)
    return apply_norm(cfg, params["enc_norm"], x)


def _cross_cache(cfg, params, enc):
    """Every decoder layer's cross-attention k/v of the encoder's output,
    stacked ``{"k", "v"}: [L, B, src_len, Hkv, Dh]``."""
    kvs = [kv_proj(cfg, lp["cross"], enc)
           for lp in unstack(params["layers"], cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kvs]),
            "v": torch.stack([v for _, v in kvs])}


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
            image_embeds=None, image_pos=None, src_embeds=None,
            length: int | None = None, attend=ops.attention,
            scan=ops.rglru, wkv=ops.wkv6):
    """tokens [B, S] -> (last-token logits [B, 1, V], decode cache).

    The cache is laid out as :func:`init_cache` lays it out: dense, moe and
    vlm ``{"kv": {"k", "v"}: [L, B, capacity, Hkv, Dh], "idx"}``; audio the
    same plus ``"cross": {"k", "v"}: [L, B, src_len, Hkv, Dh]``; hybrid
    ``{"blocks", "rem", "idx"}``, whose attention layers keep a ring of
    ``min(capacity, local_window)`` positions and whose recurrent layers
    keep ``{"h", "conv"}``; ssm ``{"state": {"tm_shift", "cm_shift", "S"},
    "idx"}`` with a leading layer axis (``capacity`` unused). A dense config
    with ``window`` attends within it and keeps the trailing ``capacity``
    positions, as a ring (absolute position ``p`` at slot ``p % capacity``)
    when ``capacity == window``.

    vlm: ``image_embeds`` [B, n, D] replace the token embeddings at
    ``image_pos`` [B, n] (early fusion). audio: ``src_embeds`` [B, src_len,
    D] (the stubbed frontend's frames) run through the encoder, which every
    decoder layer cross-attends.

    ``length`` (≤ S) marks the prompt as right-padded: logits are taken at
    position ``length - 1`` and the cache resumes from position ``length``.
    Pad positions are causally masked, so the valid outputs are unchanged; a
    recurrent state would fold the pad tokens in, so the hybrid and ssm
    families refuse it, as the JAX package's docstring does (its MoE
    capacity grows with the pads, so the engine never pads an moe prompt).

    ``attend``, ``scan`` and ``wkv`` run the prefill attention (``[B, H, S,
    Dh]`` layout), the RG-LRU recurrence and the WKV recurrence: the
    kernels' dispatch in :mod:`repro_torch.kernels.ops` unless the caller
    passes the plain versions.
    """
    require_ported(cfg)
    B, S = tokens.shape
    x = embed(cfg, params["embed"], tokens)
    if cfg.family == "vlm" and image_embeds is not None:
        x = _merge_image_embeds(x, image_embeds, image_pos)
    positions = torch.arange(S, device=tokens.device)
    if cfg.family in ("hybrid", "ssm") and length is not None:
        raise ValueError(f"prefill(length=) pads the prompt, which the "
                         f"{cfg.family} family's recurrent state would "
                         "absorb")
    idx = S if length is None else int(length)
    if cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            x, st = _rwkv_layer(cfg, layer_params(params["layers"], i), x,
                                wkv=wkv)
            states.append(st)
        cache = {"state": _stack(states), "idx": idx}
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
                 "rem": rem, "idx": idx}
    else:
        if cfg.family == "audio":
            if src_embeds is None:
                raise ValueError("the audio family's prefill needs "
                                 "src_embeds")
            enc = _encode(cfg, params, src_embeds, attend=attend)
            cross = []
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = layer_params(params["layers"], i)
            if cfg.family == "audio":
                x, (k, v), ckv = _encdec_layer_kv(cfg, lp, x, enc, positions,
                                                  attend=attend)
                cross.append(ckv)
            else:
                x, (k, v) = _attn_layer_kv(cfg, lp, x, positions,
                                           window=cfg.window, attend=attend)
            k, v = _kv_to_cache(k, v, capacity, cfg.window)
            ks.append(k)
            vs.append(v)
        cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                 "idx": idx}
        if cfg.family == "audio":
            cache["cross"] = {"k": torch.stack([k for k, _ in cross]),
                              "v": torch.stack([v for _, v in cross])}
    x = apply_norm(cfg, params["final_norm"], x[:, idx - 1:idx])
    return unembed(cfg, params["embed"], x), cache


def _cache_device(device) -> torch.device:
    """``resolve_device``, and the ``meta`` device, on which
    :func:`cache_batch_axes` builds caches of shapes only."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, *,
               device: str | torch.device = "cuda", src_embeds=None,
               params=None, attend=ops.attention) -> Params:
    """Empty decode cache in ``cfg.dtype``: dense, moe and vlm ``{"kv":
    {"k", "v"}, "idx": 0}`` with k/v ``[L, batch, capacity, Hkv, Dh]``;
    audio the same plus ``"cross"``, the cross-attention k/v ``[L, B,
    src_len, Hkv, Dh]`` of ``src_embeds`` [B, src_len, D] run through the
    encoder of ``params`` (its attention through ``attend``); hybrid
    ``{"blocks", "rem", "idx": 0}`` with each block leaf stacked
    ``[n_blocks, batch, ...]``: attention rings k/v ``[batch, min(capacity,
    local_window), Hkv, Dh]``, recurrent state h ``[batch, R]`` and conv
    ``[batch, conv1d_width - 1, R]``; ssm ``{"state", "idx": 0}`` with
    ``tm_shift``/``cm_shift`` ``[L, batch, D]`` and S ``[L, batch, H, Dh,
    Dh]`` in f32 (``capacity`` unused). ``device="meta"`` builds the shapes
    only (the kernels' wrappers take meta tensors to their plain
    versions)."""
    require_ported(cfg)
    dev = _cache_device(device)
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
    cache = {"kv": {name: t.reshape(cfg.n_layers, batch, *t.shape[1:])
                    for name, t in kv.items()},
             "idx": 0}
    if cfg.family == "audio":
        if src_embeds is None or params is None:
            raise ValueError("the audio family's cache needs src_embeds and "
                             "params")
        cache["cross"] = _cross_cache(
            cfg, params, _encode(cfg, params, src_embeds, attend=attend))
    return cache


def _meta_cache(cfg, batch, capacity, params, src_len):
    """:func:`init_cache` on the meta device (audio: with meta copies of
    ``params`` and meta source frames of ``src_len``)."""
    src = meta_params = None
    if cfg.family == "audio":
        if params is None:
            raise ValueError("the audio family's cache axes need params")
        meta_params = tree_to(params, device="meta")
        src = torch.empty((batch, src_len or cfg.src_len, cfg.d_model),
                          dtype=cfg.dtype, device="meta")
    return init_cache(cfg, batch, capacity, device="meta", src_embeds=src,
                      params=meta_params)


def _diff_axes(a, b):
    """The one axis along which each tensor leaf of ``a`` and ``b`` differs,
    ``-1`` where none does (and for the non-tensor ``idx``)."""
    if isinstance(a, dict):
        return {k: _diff_axes(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_diff_axes(x, y) for x, y in zip(a, b)]
    if not isinstance(a, torch.Tensor):
        return -1
    diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if len(diff) > 1:
        raise AssertionError(f"two axes differ: {a.shape} {b.shape}")
    return diff[0] if diff else -1


def cache_batch_axes(cfg: ModelConfig, capacity: int, *, params=None,
                     src_len: int | None = None) -> Params:
    """Tree (the structure of :func:`init_cache`'s output) giving the batch
    axis of every cache leaf, ``-1`` for batch-invariant leaves (``idx``).
    Found as the JAX package finds it: :func:`init_cache` on the ``meta``
    device at batch 1 and 2, the shapes diffed. The audio family needs
    ``params`` (its cache runs the encoder)."""
    return _diff_axes(_meta_cache(cfg, 1, capacity, params, src_len),
                      _meta_cache(cfg, 2, capacity, params, src_len))


def cache_capacity_axes(cfg: ModelConfig, capacity: int, *, params=None,
                        src_len: int | None = None) -> Params:
    """Tree giving the *capacity* axis of every cache leaf, ``-1`` for
    leaves that do not grow with the KV capacity (``idx``, recurrent state,
    cross-attention caches, rings once the window saturates): the shapes
    of :func:`init_cache` at ``capacity`` and ``2 * capacity`` diffed."""
    return _diff_axes(_meta_cache(cfg, 1, capacity, params, src_len),
                      _meta_cache(cfg, 1, 2 * capacity, params, src_len))


# ---------------------------------------------------------------------------
# Decode: one token per slot against the cache
# ---------------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: Params, tokens, cache, *,
                wkv=ops.wkv6, moe_per_token: bool = False):
    """tokens [B, 1] -> (logits [B, 1, V], cache).

    ``cache["idx"]`` is the absolute position of this token: one for the
    batch, or a ``[B]`` tensor, one per slot (the slot layout of
    :func:`repro_torch.serve.batch.init_slot_cache`). Every cache leaf is
    written in place (the audio family's ``cross`` is read only); the
    returned cache holds them and ``idx + 1``. The hybrid family's attention
    layers, and a dense config with ``window``, write their rings at ``idx %
    capacity``; the ssm family's WKV step runs through ``wkv`` (the kernels'
    dispatch unless the caller passes the plain version). The MoE family
    routes the batch jointly, or each slot alone with ``moe_per_token``.
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
            if cfg.family == "audio":
                cross = layer_params(cache["cross"], i)
                x = x + cross_attention(cfg, lp["cross"],
                                        apply_norm(cfg, lp["norm2"], x),
                                        kv_cache=cross)
                x = x + mlp(cfg, lp["mlp"], apply_norm(cfg, lp["norm3"], x))
            else:
                x = x + ffn(cfg, lp, apply_norm(cfg, lp["norm2"], x),
                            moe_per_token=moe_per_token)
        new_cache = {"kv": kv}
        if cfg.family == "audio":
            new_cache["cross"] = cache["cross"]
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), {**new_cache,
                                              "idx": cache["idx"] + 1}
