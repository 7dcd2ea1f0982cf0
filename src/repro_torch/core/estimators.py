"""Gradient estimators: momentum (Eq. 7) and STORM variance reduction (Eq. 10).

Both operate on arbitrary pytrees of per-node quantities: pure functions of
tensors with a leading node axis K. The counterpart of
``repro.core.estimators``.
"""
from __future__ import annotations

from repro_torch.core.hypergrad import tree_map


def momentum_update(prev, grad, a: float):
    """U_t = (1 − a) U_{t−1} + a Δ_t    with a = α·η ∈ (0, 1]   (Eq. 7)."""
    return tree_map(lambda u, d: (1.0 - a) * u + a * d, prev, grad)


def storm_update(prev, grad_now, grad_prev, a: float):
    """U_t = (1 − a)(U_{t−1} + Δ_t − Δ_{t−1|t}) + a Δ_t    with a = α·η² (Eq. 10).

    ``grad_prev`` must be evaluated at the *previous* parameters with the
    *current* sample (the STORM correction term).
    """
    def leaf(u, d_now, d_prev):
        return (1.0 - a) * (u + d_now - d_prev) + a * d_now
    return tree_map(leaf, prev, grad_now, grad_prev)


def sgd_update(prev, grad, a: float):
    """Vanilla stochastic gradient (DSBO baseline): the estimator IS the grad."""
    del prev, a
    return grad
