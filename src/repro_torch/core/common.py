"""Shared plumbing for the decentralized bilevel algorithms.

Conventions
-----------
* Every per-node quantity (parameters X/Y, estimators U/V, trackers Z) is a
  pytree whose leaves carry a **leading node axis K**.
* A step batch is ``{'f': ξ, 'g': ζ0, 'h': ζ_{1..J}}`` where leaves of 'f'/'g'
  have leading axis K and leaves of 'h' have leading axes (K, J).
* Per-node randomness is the Neumann truncation level J̃, an integer tensor
  of shape (K,) that the caller draws (the JAX package passes K PRNG keys).

The counterpart of ``repro.core.common``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.hypergrad import (HypergradConfig, stochastic_hypergrad,
                                        tree_map)
from repro_torch.core.problems import BilevelProblem

Batch = Any
Tree = Any


@dataclasses.dataclass(frozen=True)
class HParams:
    """Step sizes of Algorithms 1/2. ``eta``∈(0,1); momentum factors are
    α1·η / α2·η for MDBO (Eq. 7) and α1·η² / α2·η² for VRDBO (Eq. 10)."""

    eta: float = 0.1
    alpha1: float = 1.0
    alpha2: float = 1.0
    beta1: float = 1.0
    beta2: float = 1.0


def node_grads(problem: BilevelProblem, cfg: HypergradConfig,
               X: Tree, Y: Tree, batch: Batch, jtilde: torch.Tensor):
    """Per-node (Δ^F̃, Δ^g): stochastic hypergradient wrt x and ∇_y g, vmapped
    over the node axis, with node k's own truncation level ``jtilde[k]``.
    All Hessian/Jacobian work stays inside the node."""

    def one(x, y, fb, gb, hb, jt):
        hg = stochastic_hypergrad(problem, cfg, x, y, fb, gb, hb, jt)
        gy = torch.func.grad(problem.lower_loss, argnums=1)(x, y, gb)
        return hg, gy

    return torch.func.vmap(one)(X, Y, batch["f"], batch["g"], batch["h"],
                                jtilde)


def consensus_error(tree: Tree) -> torch.Tensor:
    """(1/K)‖A − Ā‖_F² over all leaves (the paper's consensus diagnostic)."""
    def leaf(a):
        mean = torch.mean(a, dim=0, keepdim=True)
        return torch.sum((a - mean) ** 2) / a.shape[0]
    return functools.reduce(torch.add,
                            pytree.tree_leaves(tree_map(leaf, tree)))


def node_mean(tree: Tree) -> Tree:
    return tree_map(lambda a: torch.mean(a, dim=0), tree)


def replicate(tree: Tree, K: int) -> Tree:
    """Stack K identical copies (the paper's x_0^{(k)} = x_0 initialisation),
    each node's copy its own memory."""
    return tree_map(lambda a: a[None].expand((K,) + a.shape).clone(), tree)
