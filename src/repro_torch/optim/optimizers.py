"""Minimal optimizer library on tensor trees: the counterpart of
``repro.optim.optimizers``, update for update.

Each optimizer is ``init(params) -> state`` and ``update(grads, state,
params, lr) -> (updates, state)``; apply with
``tree_map(lambda p, u: p + u, params, updates)``. The moments are f32
whatever the parameters' dtype, and each update is cast back to its
parameter's dtype, as in the JAX package. The decentralized bilevel trainer
uses the paper's own update rules (:mod:`repro_torch.core`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

Tree = Any
tree_map = pytree.tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Tree | None = None
    nu: Tree | None = None


def _step0(params) -> torch.Tensor:
    leaves = pytree.tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """``grads`` scaled by ``min(1, max_norm / (‖grads‖ + 1e-9))``, the norm
    over every leaf in f32, each leaf kept in its dtype."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in pytree.tree_leaves(grads)))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def sgd():
    def init(params):
        return OptState(step=_step0(params))

    def update(grads, state, params, lr):
        ups = tree_map(lambda g: -lr * g, grads)
        return ups, OptState(step=state.step + 1)

    return init, update


def momentum_sgd(beta: float = 0.9):
    def init(params):
        return OptState(step=_step0(params),
                        mu=tree_map(torch.zeros_like, params))

    def update(grads, state, params, lr):
        mu = tree_map(lambda m, g: beta * m + g, state.mu, grads)
        ups = tree_map(lambda m: -lr * m, mu)
        return ups, OptState(step=state.step + 1, mu=mu)

    return init, update


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    def init(params):
        def z():
            return tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        return OptState(step=_step0(params), mu=z(), nu=z())

    def update(grads, state, params, lr):
        t = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v
                      + (1 - b2) * torch.square(g.to(torch.float32)),
                      state.nu, grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def leaf(m, v, p):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return (-lr * (upd + weight_decay * p.to(torch.float32))
                    ).to(p.dtype)

        ups = tree_map(leaf, mu, nu, params)
        return ups, OptState(step=t, mu=mu, nu=nu)

    return init, update
