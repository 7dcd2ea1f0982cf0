"""Carry parameters over from the JAX package.

``params_from_jax`` turns the JAX parameter pytree — converted to numpy by
the caller, e.g. ``jax.tree.map(np.asarray, params)`` — into the port's
tree: ``embed.table``, the layer-stacked ``layers`` with leading axis L, and
``final_norm``. ``truncate_params`` cuts such a tree to its first layers
(a speculative draft). The trees match leaf for leaf, so both packages compute
with identical weights. The port never imports JAX; only the numpy tree
crosses over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

DENSE_KEYS = {"embed", "final_norm", "layers"}


def params_from_jax(tree, *, device: str | torch.device = "cuda"):
    """JAX parameter pytree of numpy arrays -> the port's parameter tree of
    tensors on ``device`` (dtypes kept)."""
    if set(tree) != DENSE_KEYS:
        raise ValueError(f"expected the dense family's parameter tree "
                         f"{sorted(DENSE_KEYS)}, got {sorted(tree)}")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t)).to(dev)

    return conv(tree)


def truncate_params(params, n_layers: int):
    """The first ``n_layers`` layers of a dense parameter tree, with its
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
