"""Communication topologies (Assumption 1 of the paper) + edge-delay models.

The network of K participants is described by a symmetric doubly-stochastic
mixing matrix ``W`` with eigenvalues ``1 = |λ1| > |λ2| >= ... >= |λK|``.
The spectral gap ``1 - λ`` (λ = |λ2|) controls every rate in the paper.

:class:`EdgeDelayModel` extends the static picture with per-directed-edge
communication *delays* for wall-clock simulation (host-side numpy; nothing
here runs on device): synchronous gossip pays ``compute + max over edges``
per round, asynchronous stale-by-τ gossip pays
``compute + deadline`` and converts the tail of the delay distribution into
the per-edge drop probability :meth:`EdgeDelayModel.drop_prob`.

A copy of ``repro.core.topology``: the module is numpy only, so W, the
spectral gap and the drop probabilities equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    size: int
    weights: np.ndarray  # (K, K) mixing matrix W

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.lam

    @property
    def lam(self) -> float:
        """λ = |λ2|, the second largest eigenvalue magnitude of W."""
        eig = np.sort(np.abs(np.linalg.eigvalsh(self.weights)))
        return float(eig[-2]) if self.size > 1 else 0.0

    def neighbors(self, k: int) -> list[int]:
        return [j for j in range(self.size) if j != k and self.weights[k, j] > 0]

    def check_assumption1(self, atol: float = 1e-8) -> None:
        W = self.weights
        if not np.allclose(W, W.T, atol=atol):
            raise ValueError(f"{self.name}: W is not symmetric")
        if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
            raise ValueError(f"{self.name}: W is not (doubly) stochastic")
        if self.size > 1 and not self.lam < 1.0 - 1e-12:
            raise ValueError(f"{self.name}: spectral gap is zero (disconnected?)")


def _from_adjacency(name: str, adj: np.ndarray) -> Topology:
    """Metropolis-Hastings weights from a 0/1 adjacency matrix.

    w_ij = 1 / (1 + max(deg_i, deg_j)) for edges, w_ii = 1 - sum_j w_ij.
    Always symmetric + doubly stochastic for undirected graphs.
    """
    K = adj.shape[0]
    adj = np.asarray(adj, dtype=bool)
    np.fill_diagonal(adj, False)
    deg = adj.sum(axis=1)
    W = np.zeros((K, K))
    for i in range(K):
        for j in range(K):
            if adj[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return Topology(name, K, W)


def ring(K: int, self_weight: float = 1.0 / 3.0) -> Topology:
    """Ring network (the paper's §6 experiments). Tridiagonal-circulant W.

    Default weights: 1/3 self, 1/3 each neighbor (K>2). For K=1 returns [[1]];
    for K=2 the two nodes average.
    """
    if K == 1:
        return Topology("ring", 1, np.ones((1, 1)))
    if K == 2:
        return Topology("ring", 2, np.full((2, 2), 0.5))
    nb = (1.0 - self_weight) / 2.0
    W = np.eye(K) * self_weight
    for k in range(K):
        W[k, (k - 1) % K] += nb
        W[k, (k + 1) % K] += nb
    return Topology("ring", K, W)


def complete(K: int) -> Topology:
    return Topology("complete", K, np.full((K, K), 1.0 / K))


def star(K: int) -> Topology:
    adj = np.zeros((K, K))
    adj[0, 1:] = 1
    adj[1:, 0] = 1
    return _from_adjacency("star", adj)


def torus2d(rows: int, cols: int) -> Topology:
    """2-D torus (every node linked to its four grid neighbours)."""
    K = rows * cols
    adj = np.zeros((K, K))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                j = (rr % rows) * cols + (cc % cols)
                if j != i:
                    adj[i, j] = 1
    return _from_adjacency(f"torus{rows}x{cols}", adj)


def erdos_renyi(K: int, p: float = 0.5, seed: int = 0) -> Topology:
    rng = np.random.default_rng(seed)
    while True:
        adj = rng.random((K, K)) < p
        adj = np.triu(adj, 1)
        adj = adj | adj.T
        topo = _from_adjacency(f"erdos{K}", adj)
        if K == 1 or topo.lam < 1.0 - 1e-9:  # connected
            return topo


@dataclasses.dataclass(frozen=True)
class EdgeDelayModel:
    """Per-directed-edge communication delay for wall-clock simulation.

    Each round, edge ``e`` takes

        delay_e = base_s[e] + Exp(straggler_scale_s[e])   w.p. straggler_prob[e]
        delay_e = base_s[e]                               otherwise

    All three parameters broadcast over the directed-edge axis, so
    heterogeneous links (e.g. every edge into one slow node) get their own
    statistics. Host-side numpy only — the device never sees delays; the
    async mix backend consumes them reduced to :meth:`drop_prob`.
    """

    base_s: float | np.ndarray = 1e-3
    straggler_prob: float | np.ndarray = 0.0
    straggler_scale_s: float | np.ndarray = 0.0

    def sample(self, rng: np.random.Generator, n_edges: int,
               rounds: int = 1) -> np.ndarray:
        """(rounds, n_edges) sampled per-edge delays."""
        base = np.broadcast_to(np.asarray(self.base_s, float), (n_edges,))
        p = np.broadcast_to(np.asarray(self.straggler_prob, float), (n_edges,))
        scale = np.broadcast_to(
            np.asarray(self.straggler_scale_s, float), (n_edges,))
        straggle = rng.random((rounds, n_edges)) < p
        extra = np.where(scale > 0,
                         rng.exponential(1.0, (rounds, n_edges)) * scale, 0.0)
        return base + straggle * extra

    def sync_round_s(self, rng: np.random.Generator, n_edges: int,
                     rounds: int = 1) -> np.ndarray:
        """(rounds,) synchronous-gossip comm cost: every node barriers on its
        in-edges, and gradient tracking chains rounds, so a round completes
        when the *slowest edge anywhere* lands — max over the edge axis."""
        return self.sample(rng, n_edges, rounds).max(axis=1)

    def adaptive_deadline(self, quantile: float, observed=None, *,
                          n_edges: int | None = None, rounds: int = 256,
                          rng: np.random.Generator | None = None) -> float:
        """Pick the async-gossip comm cutoff from the observed delay tail.

        Returns the ``quantile``-th quantile of per-edge delays: the deadline
        at which roughly ``1 - quantile`` of edge deliveries miss the cutoff
        and fall back to stale cached values. ``observed`` is any array of
        measured delays (e.g. from a running deployment); when omitted, the
        model samples its own ``(rounds, n_edges)`` delays — the simulation
        stand-in for observing a real network. A fixed deadline must be
        hand-tuned per delay distribution; the adaptive one keeps the
        drop-rate (and therefore the staleness/iteration-rate trade) pinned
        as the tail changes."""
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        if observed is None:
            if n_edges is None:
                raise ValueError("need n_edges to sample when no observed "
                                 "delays are given")
            rng = np.random.default_rng(0) if rng is None else rng
            observed = self.sample(rng, n_edges, rounds)
        return float(np.quantile(np.asarray(observed, float).ravel(),
                                 quantile))

    def drop_prob(self, deadline_s: float, n_edges: int) -> np.ndarray:
        """(n_edges,) P(delay > deadline) — the async mix's per-edge drop
        probability when delivery is cut off at ``deadline_s``."""
        base = np.broadcast_to(np.asarray(self.base_s, float), (n_edges,))
        p = np.broadcast_to(np.asarray(self.straggler_prob, float), (n_edges,))
        scale = np.broadcast_to(
            np.asarray(self.straggler_scale_s, float), (n_edges,))
        slack = deadline_s - base
        # exponent masked to 0 where slack < 0 — the outer where discards
        # that branch, but an unmasked exp would overflow-warn at scale=0
        tail = np.where(scale > 0,
                        np.exp(-np.maximum(slack, 0.0)
                               / np.maximum(scale, 1e-300)), 0.0)
        return np.where(slack < 0, 1.0, p * tail)


def ring_edge_drop_probs(model: EdgeDelayModel, K: int,
                         deadline_s: float) -> np.ndarray:
    """(K, 2) drop probabilities for the ring's directed in-edges, in the
    (left in-edge, right in-edge) column order ``AsyncGossipMix`` expects.
    Edge ordering: edges 0..K−1 are the left in-edges (node i−1 → i), edges
    K..2K−1 the right in-edges (node i+1 → i)."""
    return model.drop_prob(deadline_s, 2 * K).reshape(2, K).T


REGISTRY: dict[str, Callable[[int], Topology]] = {
    "ring": ring,
    "complete": complete,
    "star": star,
    "erdos": erdos_renyi,
}


def get(name: str, K: int) -> Topology:
    if name.startswith("torus"):
        r, c = name[len("torus"):].split("x")
        return torus2d(int(r), int(c))
    return REGISTRY[name](K)
