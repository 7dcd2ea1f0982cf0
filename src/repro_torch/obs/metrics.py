"""Device-side metric accumulation: the in-chunk half of ``repro_torch.obs``.

A :class:`MetricSpec` names one metric and gives a function of one step's
context that returns a device tensor; a :class:`MetricSet` turns a list of
specs into zero accumulators on the device (:meth:`MetricSet.init`), a
per-step update that adds into them in place (:meth:`MetricSet.update`,
run by every step of the engine's fused chunk, so a captured chunk's CUDA
graph replays the adds into the same buffers), and a host-side
:meth:`MetricSet.drain` run once per chunk boundary, where the engine
already touches the host, followed by :meth:`MetricSet.reset`.

Three kinds:

* ``counter`` — an f32 scalar; the spec's fn returns the per-step
  increment (e.g. bytes shipped per gossip round).
* ``mean`` — an f32 (sum, count) pair; drained as sum / count (chunk-mean
  of a per-step scalar: consensus error, update norms, estimator norms).
* ``hist`` — an int32 (bins,) count vector; the fn returns the per-step
  count increment (e.g. async-gossip edge ages, counted by comparison with
  a fixed ``arange``: ``torch.bincount`` sizes its output from the data
  and cannot be captured).

The step context is a dict: ``{"old": state before the step, "new": state
after, "mix_states": tuple of the stateful mix's per-site slots or None}``.
Spec fns must not branch on data or read values back to the host (they run
inside a CUDA graph capture); ``drain`` is the only host-side code here.

:func:`trainer_metric_set` builds the engine's standard trainer set from
the state and the mix call sites the engine discovers: consensus error,
parameter-update norms, the hypergradient-estimator norm, compressed
payload bytes per mix round, and — for ``async_gossip`` — the realized
per-edge staleness histogram read off the mix's age counters.

The counterpart of ``repro.obs.metrics``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

KINDS = ("counter", "mean", "hist")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named metric: ``fn(ctx) -> tensor`` evaluated once per step.

    ``fn`` returns a scalar for ``counter``/``mean`` and a (bins,) integer
    increment vector for ``hist``."""

    name: str
    kind: str
    fn: Callable[[dict], Any]
    bins: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == "hist" and self.bins < 1:
            raise ValueError(f"hist metric {self.name!r} needs bins >= 1")


class MetricSet:
    """A fixed registry of :class:`MetricSpec`: ``init(device) -> acc``,
    ``update(acc, ctx)`` (in place, on the device), ``drain(acc) -> [(name,
    kind, python value)]`` and ``reset(acc)`` (host side)."""

    def __init__(self, specs: list[MetricSpec]):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate metric names in {names}")
        self.specs = tuple(specs)

    def __len__(self) -> int:
        return len(self.specs)

    def init(self, device) -> dict:
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        acc: dict[str, Any] = {}
        for s in self.specs:
            if s.kind == "counter":
                acc[s.name] = zeros()
            elif s.kind == "mean":
                acc[s.name] = (zeros(), zeros())
            else:
                acc[s.name] = zeros(s.bins, dtype=torch.int32)
        return acc

    def update(self, acc: dict, ctx: dict) -> None:
        for s in self.specs:
            v = s.fn(ctx)
            if s.kind == "mean":
                tot, cnt = acc[s.name]
                tot.add_(v)
                cnt.add_(1.0)
            else:
                acc[s.name].add_(v)

    def drain(self, acc: dict) -> list[tuple[str, str, Any]]:
        """Host-side read-out of one chunk's accumulators."""
        rows: list[tuple[str, str, Any]] = []
        for s in self.specs:
            if s.kind == "counter":
                rows.append((s.name, "counter", float(acc[s.name])))
            elif s.kind == "mean":
                tot, cnt = (float(x) for x in acc[s.name])
                rows.append((s.name, "mean", tot / max(cnt, 1.0)))
            else:
                rows.append((s.name, "hist",
                             acc[s.name].cpu().numpy().astype(np.int64)))
        return rows

    def reset(self, acc: dict) -> None:
        for t in pytree.tree_leaves(acc):
            t.zero_()


# ---------------------------------------------------------------------------
# Spec-building helpers (functions of the engine's step context)
# ---------------------------------------------------------------------------

def tree_l2(tree) -> torch.Tensor:
    """Global l2 norm over every leaf of a pytree (f32)."""
    sq = [torch.sum(torch.square(a.to(torch.float32)))
          for a in pytree.tree_leaves(tree)]
    return torch.sqrt(functools.reduce(torch.add, sq))


def tree_diff_l2(new, old) -> torch.Tensor:
    return tree_l2(pytree.tree_map(lambda a, b: a - b, new, old))


def _site_bytes(site, ratio: float, weights) -> int:
    """Communicated bytes per gossip round for one mix call site, from the
    shapes and dtypes of ``site`` (tensors on any device, meta included);
    :func:`repro_torch.core.compression.comm_bytes_per_mix`'s count."""
    if weights is None:
        degree = 2  # ring
    else:
        W = np.asarray(weights)
        off = (np.abs(W) > 0) & ~np.eye(W.shape[0], dtype=bool)
        degree = int(off.sum(axis=1).max())
    total = 0
    for t in pytree.tree_leaves(site):
        d = t.numel() // max(t.shape[0], 1) if t.dim() else 1
        kept = max(int(d * ratio), 1)
        per_entry = t.element_size() + (4 if ratio < 1.0 else 0)
        total += degree * kept * per_entry
    return total


def staleness_hist_fn(bins: int) -> Callable[[dict], torch.Tensor]:
    """Histogram increment over the async-gossip age counters: one count per
    directed in-edge per mix call site per step, binned by realized age (the
    age of the cached value each node actually mixed with this round)."""

    def fn(ctx):
        h = 0
        for st in ctx["mix_states"] or ():
            for ages in (st["age_left"], st["age_right"]):
                bin_of = torch.arange(bins, dtype=ages.dtype,
                                      device=ages.device)
                hit = ages.clamp(0, bins - 1)[:, None] == bin_of
                h = h + hit.sum(0, dtype=torch.int32)
        return h

    return fn


def trainer_metric_set(state, *, mix=None, mix_sites=(), ratio: float = 1.0,
                       weights=None) -> MetricSet:
    """The Engine's standard in-chunk trainer metrics.

    ``state`` is the node-stacked algorithm state at t = 0; ``mix_sites``
    are the per-call-site trees the engine discovers (meta tensors);
    ``ratio``/``weights`` parameterize the static bytes-per-round count;
    ``mix`` (the live mix object) opts in the async staleness histogram
    when it carries ``tau`` age counters."""
    specs = [
        MetricSpec("train_consensus_x", "mean",
                   lambda ctx: _consensus(ctx["new"].x)),
        MetricSpec("train_consensus_y", "mean",
                   lambda ctx: _consensus(ctx["new"].y)),
        MetricSpec("train_update_norm_x", "mean",
                   lambda ctx: tree_diff_l2(ctx["new"].x, ctx["old"].x)),
        MetricSpec("train_update_norm_y", "mean",
                   lambda ctx: tree_diff_l2(ctx["new"].y, ctx["old"].y)),
    ]
    if hasattr(state, "u"):
        specs.append(MetricSpec("train_hypergrad_norm_u", "mean",
                                lambda ctx: tree_l2(ctx["new"].u)))
    if mix_sites:
        bytes_per_step = float(sum(_site_bytes(t, ratio, weights)
                                   for t in mix_sites))
        specs.append(MetricSpec("train_mix_bytes", "counter",
                                lambda ctx: bytes_per_step))
    tau = getattr(mix, "tau", None)
    if tau is not None and getattr(mix, "stateful", False):
        bins = int(tau) + 1
        specs.append(MetricSpec("train_staleness", "hist",
                                staleness_hist_fn(bins), bins=bins))
    return MetricSet(specs)


def _consensus(tree) -> torch.Tensor:
    # a copy of core.common.consensus_error: obs imports nothing of core
    def leaf(a):
        mean = torch.mean(a, dim=0, keepdim=True)
        return torch.sum((a - mean) ** 2) / a.shape[0]
    return functools.reduce(torch.add,
                            [leaf(a) for a in pytree.tree_leaves(tree)])
