"""VRDBO — Variance-Reduction-based Decentralized Stochastic Bilevel Opt (Alg. 2).

Uses the STORM estimator (Eq. 10):

  U_t = (1 − α1 η²)(U_{t−1} + Δ^F̃_t − Δ^F̃_{t−1|t}) + α1 η² Δ^F̃_t

where Δ^F̃_{t−1|t} is evaluated at the *previous* iterate (X_{t−1}, Y_{t−1})
with the *current* sample ξ̃_t — including the same Neumann truncation level J̃
and Hessian minibatches ζ_j, as STORM requires a common sample
for the correction pair. Tracking/update identical to MDBO. t=0 uses mini-batch
size B (Line 3) — pass a larger batch to :func:`init`.

The counterpart of ``repro.core.vrdbo``; per-node J̃ replaces the PRNG keys.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.common import HParams, node_grads
from repro_torch.core.estimators import storm_update
from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.tracking import MixFn, param_update, track_update

Tree = Any


class VRDBOState(NamedTuple):
    x: Tree
    y: Tree
    x_prev: Tree
    y_prev: Tree
    u: Tree
    v: Tree
    zf: Tree
    zg: Tree


def init(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
         mix: MixFn, X0: Tree, Y0: Tree, batch, jtilde) -> VRDBOState:
    """Iteration t=0 (Lines 3 + 8). ``batch`` should carry the init mini-batch
    size B along its per-node batch dimension."""
    df, dg = node_grads(problem, cfg, X0, Y0, batch, jtilde)
    x1 = param_update(X0, df, hp.eta, hp.beta1, mix)
    y1 = param_update(Y0, dg, hp.eta, hp.beta2, mix)
    return VRDBOState(x=x1, y=y1, x_prev=X0, y_prev=Y0,
                      u=df, v=dg, zf=df, zg=dg)


def step(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
         mix: MixFn, state: VRDBOState, batch, jtilde) -> VRDBOState:
    """One iteration t ≥ 1 of Algorithm 2."""
    df_now, dg_now = node_grads(problem, cfg, state.x, state.y, batch,
                                jtilde)
    # STORM correction: previous iterate, same sample AND same J̃.
    df_prev, dg_prev = node_grads(problem, cfg, state.x_prev, state.y_prev,
                                  batch, jtilde)

    a1, a2 = hp.alpha1 * hp.eta ** 2, hp.alpha2 * hp.eta ** 2
    u_new = storm_update(state.u, df_now, df_prev, a1)
    v_new = storm_update(state.v, dg_now, dg_prev, a2)

    zf_new = track_update(state.zf, u_new, state.u, mix)
    zg_new = track_update(state.zg, v_new, state.v, mix)

    x_new = param_update(state.x, zf_new, hp.eta, hp.beta1, mix)
    y_new = param_update(state.y, zg_new, hp.eta, hp.beta2, mix)
    return VRDBOState(x=x_new, y=y_new, x_prev=state.x, y_prev=state.y,
                      u=u_new, v=v_new, zf=zf_new, zg=zg_new)
