"""MDBO — Momentum-based Decentralized Stochastic Bilevel Optimization (Alg. 1).

Per iteration t:
  U_t = (1 − α1 η) U_{t−1} + α1 η Δ^F̃_t            (momentum, Eq. 7)
  V_t = (1 − α2 η) V_{t−1} + α2 η Δ^g_t
  Z^F̃_t = Z^F̃_{t−1} W + U_t − U_{t−1}              (gradient tracking, Eq. 8)
  Z^g_t = Z^g_{t−1} W + V_t − V_{t−1}
  X_{t+1} = X_t − η X_t (I − W) − β1 η Z^F̃_t        (mixed update, Eq. 9)
  Y_{t+1} = Y_t − η Y_t (I − W) − β2 η Z^g_t

t = 0 initializes U, V, Z^F̃, Z^g with the first stochastic gradients (Line 3)
— handled by :func:`init` (which also applies the t=0 parameter update).
:func:`init_zero` implements the Algorithm-3 variant (U_{−1}=Z_{−1}=0) used for
the linear-speedup analysis under Assumption 6.

The counterpart of ``repro.core.mdbo``; per-node J̃ replaces the PRNG keys.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.common import HParams, node_grads
from repro_torch.core.estimators import momentum_update
from repro_torch.core.hypergrad import HypergradConfig, tree_zeros_like
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.tracking import MixFn, param_update, track_update

Tree = Any


class MDBOState(NamedTuple):
    x: Tree
    y: Tree
    u: Tree
    v: Tree
    zf: Tree
    zg: Tree


def init(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
         mix: MixFn, X0: Tree, Y0: Tree, batch, jtilde) -> MDBOState:
    """Iteration t=0 of Algorithm 1 (Lines 3 + 8)."""
    df, dg = node_grads(problem, cfg, X0, Y0, batch, jtilde)
    x1 = param_update(X0, df, hp.eta, hp.beta1, mix)
    y1 = param_update(Y0, dg, hp.eta, hp.beta2, mix)
    return MDBOState(x=x1, y=y1, u=df, v=dg, zf=df, zg=dg)


def init_zero(X0: Tree, Y0: Tree) -> MDBOState:
    """Algorithm 3 initialisation: U_{−1} = V_{−1} = Z_{−1} = 0."""
    return MDBOState(x=X0, y=Y0,
                     u=tree_zeros_like(X0), v=tree_zeros_like(Y0),
                     zf=tree_zeros_like(X0), zg=tree_zeros_like(Y0))


def step(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
         mix: MixFn, state: MDBOState, batch, jtilde) -> MDBOState:
    """One iteration t ≥ 1 of Algorithm 1."""
    df, dg = node_grads(problem, cfg, state.x, state.y, batch, jtilde)

    a1, a2 = hp.alpha1 * hp.eta, hp.alpha2 * hp.eta
    u_new = momentum_update(state.u, df, a1)
    v_new = momentum_update(state.v, dg, a2)

    zf_new = track_update(state.zf, u_new, state.u, mix)
    zg_new = track_update(state.zg, v_new, state.v, mix)

    x_new = param_update(state.x, zf_new, hp.eta, hp.beta1, mix)
    y_new = param_update(state.y, zg_new, hp.eta, hp.beta2, mix)
    return MDBOState(x=x_new, y=y_new, u=u_new, v=v_new, zf=zf_new, zg=zg_new)
