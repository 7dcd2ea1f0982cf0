"""Baseline algorithms from the paper's §6 comparison.

* DSBO  (Chen et al., 2022): vanilla stochastic (hyper)gradients + gossip.
* GDSBO (Yang et al., 2022): momentum estimators + gossip.

As in the paper's experiments we implement the *simplified* versions where
Hessians/Jacobians are computed implicitly (matrix-free, like our methods) and
only model parameters (and, for GDSBO, gradient estimators) are communicated
via the gossip step ``X_{t+1} = X_t W − lr · D_t``.

The counterpart of ``repro.core.baselines``; per-node J̃ replaces the PRNG keys.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core.common import HParams, node_grads
from repro_torch.core.estimators import momentum_update
from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.tracking import MixFn, gossip_param_update

Tree = Any


class DSBOState(NamedTuple):
    x: Tree
    y: Tree


def dsbo_init(X0: Tree, Y0: Tree) -> DSBOState:
    return DSBOState(x=X0, y=Y0)


def dsbo_step(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
              mix: MixFn, state: DSBOState, batch, jtilde) -> DSBOState:
    df, dg = node_grads(problem, cfg, state.x, state.y, batch, jtilde)
    x_new = gossip_param_update(state.x, df, hp.beta1 * hp.eta, mix)
    y_new = gossip_param_update(state.y, dg, hp.beta2 * hp.eta, mix)
    return DSBOState(x=x_new, y=y_new)


class GDSBOState(NamedTuple):
    x: Tree
    y: Tree
    u: Tree
    v: Tree


def gdsbo_init(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
               mix: MixFn, X0: Tree, Y0: Tree, batch, jtilde) -> GDSBOState:
    df, dg = node_grads(problem, cfg, X0, Y0, batch, jtilde)
    x1 = gossip_param_update(X0, df, hp.beta1 * hp.eta, mix)
    y1 = gossip_param_update(Y0, dg, hp.beta2 * hp.eta, mix)
    return GDSBOState(x=x1, y=y1, u=df, v=dg)


def gdsbo_step(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
               mix: MixFn, state: GDSBOState, batch, jtilde) -> GDSBOState:
    df, dg = node_grads(problem, cfg, state.x, state.y, batch, jtilde)
    a1, a2 = hp.alpha1 * hp.eta, hp.alpha2 * hp.eta
    u_new = momentum_update(state.u, df, a1)
    v_new = momentum_update(state.v, dg, a2)
    x_new = gossip_param_update(state.x, u_new, hp.beta1 * hp.eta, mix)
    y_new = gossip_param_update(state.y, v_new, hp.beta2 * hp.eta, mix)
    return GDSBOState(x=x_new, y=y_new, u=u_new, v=v_new)
