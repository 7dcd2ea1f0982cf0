"""Gradient estimators: momentum (Eq. 7) and STORM variance reduction (Eq. 10).

Both operate on arbitrary pytrees of per-node quantities: pure functions of
tensors with a leading node axis K. The counterpart of
``repro.core.estimators``; coefficients meet a leaf as JAX's weakly typed
scalars do (:func:`repro_torch.core.hypergrad.weak_scalar`).
"""
from __future__ import annotations

from repro_torch.core.hypergrad import tree_map, weak_scalar


def momentum_update(prev, grad, a: float):
    """U_t = (1 − a) U_{t−1} + a Δ_t    with a = α·η ∈ (0, 1]   (Eq. 7)."""
    def leaf(u, d):
        return weak_scalar(1.0 - a, u) * u + weak_scalar(a, d) * d
    return tree_map(leaf, prev, grad)


def storm_update(prev, grad_now, grad_prev, a: float):
    """U_t = (1 − a)(U_{t−1} + Δ_t − Δ_{t−1|t}) + a Δ_t    with a = α·η² (Eq. 10).

    ``grad_prev`` must be evaluated at the *previous* parameters with the
    *current* sample (the STORM correction term).
    """
    def leaf(u, d_now, d_prev):
        return (weak_scalar(1.0 - a, u) * (u + d_now - d_prev)
                + weak_scalar(a, d_now) * d_now)
    return tree_map(leaf, prev, grad_now, grad_prev)


def sgd_update(prev, grad, a: float):
    """Vanilla stochastic gradient (DSBO baseline): the estimator IS the grad."""
    del prev, a
    return grad
