"""Gradient-tracking + gossip mixing operators.

Two implementations of the communication primitive ``A ↦ W A`` (A stacked
over nodes on the leading axis):

* :func:`dense_mix` — paper-faithful contraction with the K×K mixing matrix.
* :func:`ring_mix_rolled` — exact rewrite for the ring topology: every node
  needs only its two neighbours, ``torch.roll`` by ±1 on the node axis plus a
  3-term weighted sum; same numbers as ``dense_mix(ring W)`` up to rounding,
  without materializing W.

The gradient-tracking recursion (Eq. 8):   Z_t = Z_{t−1} W + U_t − U_{t−1}.
Its defining invariant, mean_k Z_t^{(k)} = mean_k U_t^{(k)}, is tested.

The counterpart of ``repro.core.tracking``, with the JAX package's
numbers on bf16 leaves too (:func:`repro_torch.core.hypergrad.weak_scalar`,
:func:`contract`); the shard-local ``ring_mix_local`` waits on
``torch.distributed`` (``ROADMAP.md``, queue 1, item 6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.hypergrad import (tree_add, tree_map, tree_sub,
                                        weak_scalar)
from repro_torch.device import resolve_device

MixFn = Callable[[object], object]


def contract(Wt: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ_j Wt[i,j] a[j] in the promoted dtype of the two, as
    ``jnp.tensordot`` computes it: an f32 W contracts a bf16 leaf in f32."""
    dt = torch.promote_types(Wt.dtype, a.dtype)
    return torch.tensordot(Wt.to(dt), a.to(dt), dims=([1], [0]))


def dense_mix(W, device="cuda") -> MixFn:
    """A ↦ W A (out[i] = Σ_j W[i,j] A[j]) on every pytree leaf, leading
    axis=K, cast back to the leaf's dtype. W is held in f32 on ``device``
    (the card unless the caller names the CPU:
    :func:`repro_torch.device.resolve_device`)."""
    Wt = torch.as_tensor(W, dtype=torch.float32).to(resolve_device(device))

    def mix(tree):
        return tree_map(lambda a: contract(Wt, a).to(a.dtype), tree)

    return mix


def ring_mix_rolled(self_weight: float = 1.0 / 3.0) -> MixFn:
    """Single-process ring mixing via ``torch.roll`` on the leading node axis.

    Equivalent to dense_mix(ring(K).weights) without materializing W."""
    nb = (1.0 - self_weight) / 2.0

    def mix(tree):
        def leaf(a):
            K = a.shape[0]
            if K == 1:
                return a
            if K == 2:
                return 0.5 * a + 0.5 * torch.roll(a, 1, dims=0)
            sw, w = weak_scalar(self_weight, a), weak_scalar(nb, a)
            return (sw * a + w * torch.roll(a, 1, dims=0)
                    + w * torch.roll(a, -1, dims=0))
        return tree_map(leaf, tree)

    return mix


def track_update(z_prev, u_new, u_prev, mix: MixFn):
    """Z_t = mix(Z_{t−1}) + U_t − U_{t−1}  (Eq. 8)."""
    return tree_add(mix(z_prev), tree_sub(u_new, u_prev))


def param_update(x, z, eta: float, beta: float, mix: MixFn):
    """X_{t+1} = X_t − η X_t (I − W) − β η Z_t  (Eq. 9)
              = (1−η) X_t + η mix(X_t) − β η Z_t."""
    mixed = mix(x)

    def leaf(xx, mm, zz):
        return (weak_scalar(1.0 - eta, xx) * xx + weak_scalar(eta, mm) * mm
                - weak_scalar(beta * eta, zz) * zz)

    return tree_map(leaf, x, mixed, z)


def gossip_param_update(x, d, lr: float, mix: MixFn):
    """Baseline gossip update: X_{t+1} = mix(X_t) − lr · D_t."""
    mixed = mix(x)
    return tree_map(lambda mm, dd: mm - weak_scalar(lr, dd) * dd, mixed, d)
