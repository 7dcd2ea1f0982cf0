"""Carry parameters over from the JAX package.

``params_from_jax`` turns the JAX parameter pytree — converted to numpy by
the caller, e.g. ``jax.tree.map(np.asarray, params)`` — into the port's
tree: ``embed.table``, ``final_norm`` and, for the dense, moe, vlm and ssm
families, the layer-stacked ``layers`` with leading axis L (attention and
MLP or the MoE subtree ``router``/``wi``/``wg``/``wo``, or RWKV-6 time- and
channel-mix), for the audio family also the encoder's ``enc_layers`` and
``enc_norm`` (its decoder layers hold ``cross`` and ``norm3``), or, for the
hybrid family, the block-stacked ``blocks`` and the list of trailing layers
``rem``. ``truncate_params`` cuts a layer-stacked tree to its first layers
(a speculative draft). The trees match leaf for leaf, so both packages compute
with identical weights. The port never imports JAX; only the numpy tree
crosses over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

DENSE_KEYS = {"embed", "final_norm", "layers"}   # dense, moe, vlm and ssm
HYBRID_KEYS = {"embed", "final_norm", "blocks", "rem"}
AUDIO_KEYS = DENSE_KEYS | {"enc_layers", "enc_norm"}


def params_from_jax(tree, *, device: str | torch.device = "cuda"):
    """JAX parameter pytree of numpy arrays -> the port's parameter tree of
    tensors on ``device`` (dtypes kept)."""
    if set(tree) not in (DENSE_KEYS, HYBRID_KEYS, AUDIO_KEYS):
        raise ValueError(f"expected a parameter tree {sorted(DENSE_KEYS)} "
                         f"(dense, moe, vlm, ssm), {sorted(HYBRID_KEYS)} "
                         f"(hybrid) or {sorted(AUDIO_KEYS)} (audio), got "
                         f"{sorted(tree)}")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t)).to(dev)

    return conv(tree)


def truncate_params(params, n_layers: int):
    """The first ``n_layers`` layers of a dense, moe or vlm parameter tree
    (every leaf under ``layers``, the experts too), with its
    ``embed`` and ``final_norm``: a truncated self-speculation draft (the
    target's own early layers propose, the whole target verifies). The
    leaves are views of ``params``; the JAX package's serving benchmark
    slices its draft the same way."""
    def head(t):
        if isinstance(t, dict):
            return {k: head(v) for k, v in t.items()}
        return t[:n_layers]

    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": head(params["layers"])}
