"""Asynchronous (stale-by-τ) gossip for the ring topology.

The paper's algorithms assume *synchronous* gossip: every node waits for
both ring neighbors before each mix call site of a step, so one straggling
edge stalls the whole round. :class:`AsyncGossipMix` mixes with a **cached
copy** of the neighbors' values and refreshes the cache only when the edge
delivers in time (Yang et al., Decentralized Gossip-Based Stochastic
Bilevel Optimization, 2022), per mix call site and per directed in-edge
(left = from node i−1, right = from node i+1):

* the neighbor cache ``h`` holds the last delivered value; the fresh
  exchange is committed to it only if the edge delivered (Bernoulli
  ``1 − drop_prob``, per edge per call) OR the cache has reached the
  staleness bound ``tau``, so a used value is never more than ``tau``
  rounds old;
* ``tau=0`` forces delivery on every edge every call: the mix is
  synchronous ring gossip, bit for bit ``ring_rolled``'s (the same order of
  operations);
* with a ``compressor`` the delivered payload is the EF21-compressed
  innovation (:func:`repro_torch.core.compression.ef21_update`): the cache
  doubles as the error-feedback proxy.

The counterpart of ``repro.core.async_gossip``. The caches and age counters
live on the device in the engine's per-site slots (:meth:`state0`,
:meth:`bind`). The deliveries do not: the JAX package draws them from
threefry keys carried in its scan, which torch cannot reproduce, so here
each (seed, site, node) has a host-side numpy stream, consumed in call
order (:meth:`draws`). The engine draws each step's deliveries on the host
before the step, or before a fused chunk's CUDA graph replay, and hands
them to :meth:`bind`: per-step, fused, CPU and card runs consume the same
deliveries, and no draw happens inside a graph. The shard-local exchange
(``local=True``, ppermute in the JAX package) waits with the ``ring_local``
backend (``ROADMAP.md``, queue 1, item 6).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.compression import ef21_update
from repro_torch.core.hypergrad import tree_map, weak_scalar
from repro_torch.device import resolve_device


def _tree_where(mask, a_tree, b_tree):
    """Per-leaf ``where`` with a (K,) node mask broadcast over trailing
    dims."""
    def leaf(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return tree_map(leaf, a_tree, b_tree)


class AsyncGossipMix:
    """Stale-by-τ ring gossip with a per-edge drop model (see module doc).

    Parameters
    ----------
    K: ring size (at least 3: the K ≤ 2 rings have no distinct neighbors).
    self_weight: W_ii of the ring mixing matrix; neighbors split the rest.
    tau: staleness bound. 0 = synchronous (bit for bit ring gossip).
    drop_prob: P(edge misses the deadline) per directed in-edge per call —
        a scalar, or an array broadcastable to (K, 2) with columns (left
        in-edge, right in-edge), e.g. from
        :func:`repro_torch.core.topology.ring_edge_drop_probs`.
    seed: base seed of the per-site, per-node delivery streams.
    compressor: optional EF21 payload compressor (e.g. ``topk_sparsify``);
        delivered updates become compressed innovations against the cache.
    local: the shard-local exchange; not ported (raises).
    device: where the caches and ages live (``"cuda"`` unless named).
    """

    stateful = True

    def __init__(self, K: int, *, self_weight: float = 1.0 / 3.0,
                 tau: int = 0, drop_prob=0.0, seed: int = 0,
                 compressor: Callable | None = None, local: bool = False,
                 device="cuda"):
        if K < 3:
            raise ValueError(
                f"async_gossip needs a ring of K>=3 nodes, got {K}")
        if tau < 0:
            raise ValueError(f"tau must be >= 0, got {tau}")
        if local:
            raise NotImplementedError(
                "AsyncGossipMix(local=True): the shard-local exchange waits "
                "with the ring_local backend (ROADMAP.md, queue 1, item 6)")
        self.K, self.tau = int(K), int(tau)
        self.self_weight = float(self_weight)
        self.nb = (1.0 - self_weight) / 2.0
        self.drop_prob = np.broadcast_to(
            np.asarray(drop_prob, np.float32), (K, 2)).copy()
        self.seed, self.compressor = int(seed), compressor
        self.device = resolve_device(device)

    def _exchange(self, tree):
        """(from_left, from_right) neighbor value trees for this round."""
        return (tree_map(lambda a: torch.roll(a, 1, dims=0), tree),
                tree_map(lambda a: torch.roll(a, -1, dims=0), tree))

    def _weighted_sum(self, tree, h_left, h_right):
        """self_weight·a + nb·left + nb·right, in ``ring_mix_rolled``'s order
        of operations (the τ = 0 bit-for-bit contract)."""
        def leaf(a, hl, hr):
            sw, nb = weak_scalar(self.self_weight, a), weak_scalar(self.nb, a)
            return (sw * a + nb * hl + nb * hr).to(a.dtype)
        return tree_map(leaf, tree, h_left, h_right)

    # -- stateless form (t = 0 init: no history exists yet, so fully sync) --

    def __call__(self, tree):
        fl, fr = self._exchange(tree)
        if self.compressor is not None:  # zero caches: delivered = C(fresh)
            fl, fr = self.compressor(fl), self.compressor(fr)
        return self._weighted_sum(tree, fl, fr)

    # -- the engine's per-site protocol (as ErrorFeedbackMix's) --------------

    def state0(self, site, site_index: int):
        """The t = 0 slot of one call site: zero caches shaped like ``site``
        (a tree of tensors of the mixed tree's shapes and dtypes), and ages
        pinned at ``tau``, so the first call refreshes every edge and the
        zero caches never enter a weighted sum."""
        del site_index

        def zeros(s):
            return torch.zeros(s.shape, dtype=s.dtype, device=self.device)

        ages = torch.full((self.K,), self.tau, dtype=torch.int32,
                          device=self.device)
        return {"h_left": tree_map(zeros, site),
                "h_right": tree_map(zeros, site),
                "age_left": ages, "age_right": ages.clone()}

    def draws(self, n_sites: int) -> Callable[[], torch.Tensor]:
        """One run's delivery draws: a function whose n-th call returns the
        n-th step's deliveries, ``[n_sites, K, 2]`` bool on the host (True:
        the edge delivered). Site i, node k reads its own numpy stream,
        seeded by (seed, i, k), two uniforms a call (left, right)."""
        rngs = [[np.random.default_rng([self.seed, i, k])
                 for k in range(self.K)] for i in range(n_sites)]
        keep = 1.0 - self.drop_prob

        def draw() -> torch.Tensor:
            u = np.array([[r.random(2) for r in row] for row in rngs])
            return torch.from_numpy(u.reshape(n_sites, self.K, 2) < keep)

        return draw

    def apply(self, tree, st, land):
        """One async gossip call with this call's deliveries ``land``
        (``[K, 2]`` bool): (mixed tree, updated cache state)."""
        force_l = land[:, 0] | (st["age_left"] >= self.tau)
        force_r = land[:, 1] | (st["age_right"] >= self.tau)
        fresh_l, fresh_r = self._exchange(tree)
        if self.compressor is not None:
            fresh_l = ef21_update(st["h_left"], fresh_l, self.compressor)
            fresh_r = ef21_update(st["h_right"], fresh_r, self.compressor)
        h_l = _tree_where(force_l, fresh_l, st["h_left"])
        h_r = _tree_where(force_r, fresh_r, st["h_right"])
        new_st = {
            "h_left": h_l, "h_right": h_r,
            "age_left": torch.where(force_l, 0, st["age_left"] + 1),
            "age_right": torch.where(force_r, 0, st["age_right"] + 1),
        }
        return self._weighted_sum(tree, h_l, h_r), new_st

    def bind(self, states, draws):
        """Close over per-call-site cache states and one step's deliveries
        (``[n_sites, K, 2]``, from :meth:`draws`) for one step; the same
        call-order contract as ``ErrorFeedbackMix.bind``."""
        it = iter(zip(states, draws))
        out: list = []

        def mix(tree):
            st, land = next(it)
            mixed, st_new = self.apply(tree, st, land)
            out.append(st_new)
            return mixed

        return mix, out


def expected_staleness(tau: int, drop_prob: float) -> float:
    """Mean age of a used neighbor value under the stale-by-τ chain.

    The per-edge age follows a Markov chain on {0..tau}: refresh w.p.
    ``1−drop_prob`` (or surely at age tau), else age+1. Closed form of the
    stationary mean — a cheap analytic check for tests and benchmark tables.
    """
    q = float(np.clip(drop_prob, 0.0, 1.0))
    if tau <= 0 or q == 0.0:
        return 0.0
    # stationary weights pi_a ∝ q^a for a = 0..tau
    w = np.power(q, np.arange(tau + 1))
    return float((np.arange(tau + 1) * w).sum() / w.sum())
