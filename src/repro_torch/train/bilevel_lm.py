"""The paper's bilevel problem lifted to LM architectures.

Generalizes Eq. (19): the upper level learns per-layer L2-regularization
log-strengths x ∈ R^{n_layers+1} (the last entry covers the parameters
outside the layer stack) against validation loss; the lower level trains the
model under the x-weighted regularizer:

    g(x, θ) = CE_train(θ) + Σ_ℓ exp(x_ℓ) · mean(θ_ℓ²)
    f(x, θ) = CE_val(θ)

The counterpart of ``repro.train.bilevel_lm``. ``init_y(generator,
device)`` is :func:`repro_torch.models.init_params`; θ is the tree of
``param_dtype`` leaves, which the model casts at use, so every gradient and
Hessian-vector product is taken with respect to them.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.problems import BilevelProblem
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import require_ported


def _n_stacked(cfg: ModelConfig) -> int:
    """Length of the stacked layer axis: blocks for hybrid, layers else."""
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def _layer_reg(cfg: ModelConfig, x, params) -> torch.Tensor:
    """Σ_ℓ exp(x_ℓ)·mean(θ_ℓ²), x[-1] weighting the non-stacked params.

    A leaf whose path names ``layers`` or ``blocks`` and whose leading axis
    is the stack (``n_layers``, or the hybrid family's block count) is
    weighted layer by layer by ``exp(x[:n])``; every other leaf — the
    embedding, the final norm, the hybrid family's ``rem`` layers — by
    ``exp(x[-1])``. The audio family's ``enc_layers`` name ``layers`` too,
    as in the JAX package: with ``n_enc_layers == n_layers`` encoder layer
    ``i`` shares ``x[i]`` with decoder layer ``i``, else they go to
    ``x[-1]``. Squares are taken in the leaf's dtype and summed in f32.
    Under ``vmap`` the shapes read here are the per-node ones."""
    n = _n_stacked(cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        keys = "/".join(str(getattr(k, "key", k)) for k in path)
        sq = torch.square(leaf)
        if (("layers" in keys or "blocks" in keys) and leaf.dim() >= 1
                and leaf.shape[0] == n):
            axes = tuple(range(1, leaf.dim()))
            per = (torch.sum(sq, dim=axes, dtype=torch.float32) if axes
                   else sq.to(torch.float32))
            per = per / (leaf.numel() // n)
            total = total + torch.sum(torch.exp(x[:n]) * per)
        else:
            ss = torch.sum(sq, dtype=torch.float32) / leaf.numel()
            total = total + torch.exp(x[-1]) * ss
    return total


def x_dim(cfg: ModelConfig) -> int:
    return _n_stacked(cfg) + 1


def make_lm_bilevel_problem(cfg: ModelConfig, *, lip_gy: float = 20.0,
                            mu: float = 1e-2) -> BilevelProblem:
    require_ported(cfg)

    def lower_loss(x, theta, batch):
        return loss_fn(cfg, theta, batch) + _layer_reg(cfg, x, theta)

    def upper_loss(x, theta, batch):
        return loss_fn(cfg, theta, batch)

    return BilevelProblem(
        upper_loss=upper_loss,
        lower_loss=lower_loss,
        init_x=lambda generator, device: torch.full(
            (x_dim(cfg),), -4.0, dtype=torch.float32, device=device),
        init_y=lambda generator, device: init_params(cfg, generator,
                                                     device=device),
        lip_gy=lip_gy, mu=mu)
