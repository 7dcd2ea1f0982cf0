"""Execution engine of the decentralized bilevel run: algorithm × mix
backend × dispatch, on one device.

The counterpart of ``repro.core.engine``:

* **Dispatch** — ``per_step`` runs one eager step per call. ``fused`` runs
  an eval interval (``eval_every`` steps) as one unit, the counterpart of
  the JAX package's ``lax.scan`` chunk: on CUDA the interval is **one CUDA
  graph replay**. The graph is captured once per chunk length (and batch
  layout) and cached; it works on static state, batch, J̃ (and mix
  delivery) buffers. The chunk's draws are made on the host before the
  replay, step by step in the order per-step dispatch draws them, and
  copied into the static buffers, so no random draw happens inside the
  graph. The capture is warmed up on a copy of the state, so the warm-up
  never advances the real run. On the CPU, ``fused`` is the same plain
  loop. Either way a fused run equals a per-step run bit for bit (the same
  kernels on the same inputs in the same order), and a failed capture or
  replay fails the run: nothing falls back to eager dispatch.
* **Mix backends** — a registry of the communication primitive
  ``A ↦ W A``: ``dense`` (contraction with the K×K mixing matrix),
  ``ring_rolled`` (``torch.roll``, W-free), the compressed-gossip
  operators ``compressed_topk`` / ``compressed_rand`` (A + (W−I)·C(A); keep
  fraction via ``mix_kwargs={'ratio': ...}``, EF21 via
  ``mix_kwargs={'error_feedback': True}``), and ``async_gossip`` (stale-by-τ
  ring gossip, ``mix_kwargs={'tau': t, 'drop_prob': p}``; τ = 0 is bit for
  bit ``ring_rolled``). The JAX package's ``ring_local`` (one node per
  process) is not ported yet (``ROADMAP.md``, queue 1, item 6):
  :func:`make_mix` raises ``NotImplementedError`` for it.
* **Stateful-mix carry** — mixes that carry state between steps (EF21
  accumulators, async neighbor caches) declare ``stateful = True`` and
  expose ``state0(site, site_index)`` / ``bind(states, draws)`` /
  ``apply``. The engine finds a step's mix call sites in call order by
  running the step once on ``meta`` copies of its inputs (no arithmetic),
  seeds one slot per site, and threads ``(state, mix_states)`` through
  the steps; the algorithm bodies never see the slots. A mix that draws
  (``async_gossip``'s deliveries) has ``draws(n_sites)``, a host-side
  stream the engine reads once per step, beside J̃.
* **Observability** — with a live ``recorder`` (:mod:`repro_torch.obs`),
  a fused run accumulates :func:`repro_torch.obs.metrics.trainer_metric_set`
  on the device in every step of the chunk (inside its CUDA graph on the
  card) and drains it into the recorder at each chunk boundary; the
  numbers of the run do not change.
* **Samplers** — :class:`Sampler`. ``sample(generator)`` returns a step
  batch ``{'f','g','h'}`` with node axis K (J axis on 'h').
  :class:`repro_torch.data.NodeSampler` draws on the host from numpy (and
  ignores the generator), so its batch stream equals the JAX package's bit
  for bit; :func:`repro_torch.data.make_device_sampler` draws indices on
  the engine's device from the engine's batch generator. Batches are moved
  to the engine's device.
* **Randomness** — the JAX package's ``key_schedule`` becomes generators
  seeded from ``seed`` through ``numpy.random.SeedSequence``: one (on the
  device) for batches, one (on the host) for the per-node truncation
  levels J̃, ``[K]`` integers per step, so the CPU and the card draw the
  same J̃; and one on the host for the initial parameters, so both start
  from the same ones. :meth:`Engine.run` also takes a pre-drawn J̃
  schedule.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import baselines, mdbo, vrdbo
from repro_torch.core.async_gossip import AsyncGossipMix
from repro_torch.core.common import (HParams, consensus_error, node_mean,
                                     replicate)
from repro_torch.core.compression import (ErrorFeedbackMix, compressed_mix,
                                          random_sparsify, topk_sparsify)
from repro_torch.core.hypergrad import (HypergradConfig, draw_jtilde,
                                        tree_map, tree_zeros_like)
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.topology import Topology, ring
from repro_torch.core.estimators import momentum_update
from repro_torch.core.tracking import (MixFn, dense_mix, param_update,
                                       ring_mix_rolled, track_update)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import trainer_metric_set
from repro_torch.obs.recorder import NullRecorder

Tree = Any


# ---------------------------------------------------------------------------
# Sampler protocol
# ---------------------------------------------------------------------------

class Sampler:
    """Sampler protocol for :meth:`Engine.run`.

    ``sample(generator)`` returns a step batch ``{'f','g','h'}`` with node
    axis K (J axis on 'h'). ``device_resident`` says whether ``sample``
    draws on the engine's device (from ``generator``) or on the host. Both
    kinds are drawn outside the fused chunk's CUDA graph, one step at a
    time. Bare callables are also accepted by the engine.
    """

    device_resident: bool = True

    def sample(self, generator):
        raise NotImplementedError

    def __call__(self, generator=None):
        return self.sample(generator)


class DeviceSampler(Sampler):
    """Wrap a ``sample(generator) -> batch`` function that draws on the
    device as a Sampler."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def sample(self, generator):
        return self._fn(generator)


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Uniform signature pair:
    init(problem, cfg, hp, mix, X0, Y0, batch, jtilde) -> state
    step(problem, cfg, hp, mix, state, batch, jtilde) -> state
    """

    init: Callable
    step: Callable


def _dsbo_init(problem, cfg, hp, mix, X0, Y0, batch, jtilde):
    return baselines.dsbo_init(X0, Y0)


def _gt_sgd_grads(problem, X, Y, batch):
    """Per-node ∇_y of the raw (upper) loss on the training draw ζ0."""
    def one(x, y, b):
        return torch.func.grad(problem.upper_loss, argnums=1)(x, y, b)
    return torch.func.vmap(one)(X, Y, batch["g"])


def _gt_sgd_init(problem, cfg, hp, mix, X0, Y0, batch, jtilde):
    """Single-level gradient-tracking SGD ablation: the upper level is inert
    (x frozen at X0, its estimator/tracker slots zero — not copies of X0, or
    diagnostics that read estimator norms report parameter magnitudes)."""
    dg = _gt_sgd_grads(problem, X0, Y0, batch)
    y1 = param_update(Y0, dg, hp.eta, hp.beta2, mix)
    return mdbo.MDBOState(x=X0, y=y1, u=tree_zeros_like(X0), v=dg,
                          zf=tree_zeros_like(X0), zg=dg)


def _gt_sgd_step(problem, cfg, hp, mix, state, batch, jtilde):
    dg = _gt_sgd_grads(problem, state.x, state.y, batch)
    v_new = momentum_update(state.v, dg, hp.alpha2 * hp.eta)
    zg_new = track_update(state.zg, v_new, state.v, mix)
    y_new = param_update(state.y, zg_new, hp.eta, hp.beta2, mix)
    return mdbo.MDBOState(x=state.x, y=y_new, u=state.u, v=v_new,
                          zf=state.zf, zg=zg_new)


ALGORITHMS: dict[str, Algorithm] = {
    "mdbo": Algorithm(mdbo.init, mdbo.step),
    "vrdbo": Algorithm(vrdbo.init, vrdbo.step),
    "dsbo": Algorithm(_dsbo_init, baselines.dsbo_step),
    "gdsbo": Algorithm(baselines.gdsbo_init, baselines.gdsbo_step),
    "gt_sgd": Algorithm(_gt_sgd_init, _gt_sgd_step),
}


# ---------------------------------------------------------------------------
# Mix-backend registry
# ---------------------------------------------------------------------------

MIX_BACKENDS: dict[str, Callable[..., MixFn]] = {}

# the JAX package's other backend, not ported yet
NOT_PORTED_MIXES = ("ring_local",)


def register_mix_backend(name: str):
    def deco(builder):
        MIX_BACKENDS[name] = builder
        return builder
    return deco


@register_mix_backend("dense")
def _dense_backend(*, weights=None, K: int | None = None,
                   self_weight: float = 1.0 / 3.0, device="cuda"):
    """Paper-faithful contraction with an explicit W (default: ring(K))."""
    if weights is None:
        if K is None:
            raise ValueError("dense mix needs `weights` or `K`")
        weights = ring(K, self_weight).weights
    return dense_mix(weights, device)


@register_mix_backend("ring_rolled")
def _ring_rolled_backend(*, weights=None, K: int | None = None,
                         self_weight: float = 1.0 / 3.0, device="cuda"):
    """W-free ring via torch.roll on the leading node axis. It holds no
    tensor, but resolves ``device`` as every builder does."""
    resolve_device(device)
    return ring_mix_rolled(self_weight)


def _compression_weights(weights, K, self_weight):
    if weights is not None:
        return weights
    if K is None:
        raise ValueError("compressed mix needs `weights` or `K`")
    return ring(K, self_weight).weights


@register_mix_backend("compressed_topk")
def _compressed_topk_backend(*, weights=None, K: int | None = None,
                             self_weight: float = 1.0 / 3.0,
                             ratio: float = 0.25,
                             error_feedback: bool = False, device="cuda"):
    """Compressed gossip A + (W−I)·topk(A): only the top ``ratio`` fraction
    of entries (by magnitude, per node/leaf) crosses the network.
    ``error_feedback=True`` wraps the compressor in EF21 accumulators."""
    W = _compression_weights(weights, K, self_weight)
    comp = topk_sparsify(ratio)
    return (ErrorFeedbackMix(W, comp, device=device) if error_feedback
            else compressed_mix(W, comp, device))


@register_mix_backend("compressed_rand")
def _compressed_rand_backend(*, weights=None, K: int | None = None,
                             self_weight: float = 1.0 / 3.0,
                             ratio: float = 0.25, seed: int = 0,
                             error_feedback: bool = False, device="cuda"):
    """Compressed gossip with the random sparsifier (each leaf's mask fixed
    by ``seed`` and a stable digest of the leaf's path). The plain form
    uses the unbiased 1/ratio rescale; the EF21 form needs the contractive
    mask-only variant (the rescale would make the accumulator amplify the
    innovation by 1/ratio per call and diverge)."""
    W = _compression_weights(weights, K, self_weight)
    comp = random_sparsify(ratio, seed=seed, rescale=not error_feedback)
    return (ErrorFeedbackMix(W, comp, device=device) if error_feedback
            else compressed_mix(W, comp, device))


@register_mix_backend("async_gossip")
def _async_gossip_backend(*, weights=None, K: int | None = None,
                          self_weight: float = 1.0 / 3.0, tau: int = 0,
                          drop_prob=0.0, seed: int = 0,
                          error_feedback: bool = False, ratio: float = 1.0,
                          local: bool = False, device="cuda"):
    """Asynchronous stale-by-τ ring gossip (neighbor caches in the engine's
    per-site slots; per-edge Bernoulli drop model, drawn on the host).
    ``tau=0`` reproduces synchronous ring gossip bit for bit.
    ``error_feedback=True`` (+ ``ratio``) EF21-compresses the delivered
    payloads against the caches. Ring-only: a non-ring ``weights`` (e.g.
    from an erdos/star Topology) is rejected rather than silently remixed
    on a ring."""
    if K is None:
        raise ValueError("async_gossip needs `K` (or a Topology)")
    if weights is not None and not np.allclose(
            np.asarray(weights), ring(K, self_weight).weights):
        raise ValueError(
            "async_gossip only implements the ring topology; got a non-ring "
            f"mixing matrix for K={K} (self_weight={self_weight})")
    comp = topk_sparsify(ratio) if error_feedback else None
    return AsyncGossipMix(K, self_weight=self_weight, tau=tau,
                          drop_prob=drop_prob, seed=seed, compressor=comp,
                          local=local, device=device)


def make_mix(name: str, **kwargs) -> MixFn:
    """Build a mixing operator from the backend registry.

    kwargs: weights (dense / compressed_*), K (default-ring fallback),
    self_weight, ratio / seed / error_feedback (compressed_* /
    async_gossip), tau / drop_prob / local (async_gossip), device
    (``"cuda"`` unless the caller names another: without a card the default
    raises, as every entry point's does).
    """
    if name in NOT_PORTED_MIXES:
        raise NotImplementedError(
            f"mix={name!r}: one node per process waits on torch.distributed "
            "(ROADMAP.md, queue 1, item 6: the remaining mix backends)")
    try:
        builder = MIX_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown mix backend {name!r}; have {sorted(MIX_BACKENDS)}")
    return builder(**kwargs)


# ---------------------------------------------------------------------------
# Results container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    algo: str
    steps: list[int]
    upper_loss: list[float]
    lower_loss: list[float]
    consensus_x: list[float]
    consensus_y: list[float]
    extra: dict[str, list[float]]
    wall_time_s: float = 0.0

    def as_rows(self):
        for i, t in enumerate(self.steps):
            yield {"algo": self.algo, "step": t,
                   "upper_loss": self.upper_loss[i],
                   "lower_loss": self.lower_loss[i],
                   "consensus_x": self.consensus_x[i],
                   "consensus_y": self.consensus_y[i],
                   **{k: v[i] for k, v in self.extra.items()}}


def _copy_into(dst: Tree, src: Tree) -> None:
    """Copy ``src``'s leaves into ``dst``'s. A source leaf that is itself one
    of ``dst``'s leaves (VRDBO's ``x_prev`` after one step is the input's
    ``x``) is read before any write."""
    dst_leaves = pytree.tree_leaves(dst)
    ids = {id(d) for d in dst_leaves}
    pairs = [(d, s.clone() if id(s) in ids else s)
             for d, s in zip(dst_leaves, pytree.tree_leaves(src))
             if d is not s]
    for d, s in pairs:
        d.copy_(s)


def _layout(tree: Tree):
    """Hashable tree structure, shapes and dtypes (a graph's cache key)."""
    leaves, spec = pytree.tree_flatten(tree)
    return str(spec), tuple((tuple(t.shape), t.dtype) for t in leaves)


def _unaliased(tree: Tree) -> Tree:
    """``tree`` with every leaf its own tensor: a leaf that repeats an
    earlier one (MDBO's init state holds ``v`` and ``zg`` as one tensor) is
    cloned, the others are kept."""
    seen = set()

    def own(t):
        if id(t) in seen:
            return t.clone()
        seen.add(id(t))
        return t

    return tree_map(own, tree)


class ChunkGraph:
    """``n`` steps captured as one CUDA graph over static buffers.

    ``state`` is both the graph's input and its output: each captured step
    copies its new state into it, so each replay advances it by ``n``
    steps, and at most one step's new state is alive beside it. The graph
    adopts the given state's tensors as that buffer (with a stateful mix,
    the state is ``(state, mix_states)``: a replay advances both). Both keep
    the card's memory at what a per-step run needs (66 GB for MDBO on
    full-width ``smollm-360m`` at K = 4, of which a state is 17). Each draw
    is a ``(batch, jtilde[, deliveries])`` tuple, copied into the graph's
    own buffers before each replay. ``macc``, the obs accumulators, are
    adopted too: every captured step adds into them. ``trace`` holds each
    step's (consensus_x, consensus_y).
    """

    def __init__(self, chunk: Callable, state: Tree, draws: list,
                 macc: dict | None = None):
        clone = partial(tree_map, torch.clone)
        self.state = _unaliased(state)
        self.draws = [clone(d) for d in draws]
        # warm up (one step: the chunk repeats one step's kernels) on a side
        # stream, as torch.cuda.graph asks; a step writes nothing it reads
        # (the metrics go to scratch copies), so the warm-up advances
        # nothing real
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chunk(self.state, self.draws[:1],
                  macc=None if macc is None else clone(macc))
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _, self.trace = chunk(self.state, self.draws, in_place=True,
                                  macc=macc)

    def replay(self, state: Tree, draws: list):
        _copy_into(self.state, state)
        for d, sd in zip(draws, self.draws):
            _copy_into(sd, d)
        self.graph.replay()
        return self.state, self.trace


def _seeds(seed: int) -> tuple[int, int, int]:
    """Independent seeds for the initial parameters, the batches and J̃."""
    return tuple(int(s.generate_state(1)[0])
                 for s in np.random.SeedSequence(seed).spawn(3))


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Run substrate: algorithm × mix backend × dispatch, on ``device``.

    Parameters
    ----------
    topo: a :class:`Topology` (its W feeds the dense and compressed
        backends) or a bare node count K.
    algo: one of :data:`ALGORITHMS`.
    mix: one of :data:`MIX_BACKENDS`; ``mix_kwargs`` are passed to the backend
        (``ratio``, ``error_feedback``, ``seed``, ``tau``, ``drop_prob``).
    dispatch: ``fused`` (an eval interval per CUDA graph replay on the card,
        a plain loop on the CPU) or ``per_step`` (one eager step per call).
    recorder: a :class:`repro_torch.obs.Recorder` (fused runs accumulate
        the trainer metrics on the device and drain them at each chunk
        boundary) or None, observability off.
    device: ``"cuda"`` (the default) or ``"cpu"``; without a card the
        default raises (:func:`repro_torch.device.resolve_device`).

    After :meth:`run`, ``mix_states`` holds a stateful mix's final per-site
    slots (``()`` for a stateless mix); under fused dispatch on CUDA they
    are the graph's buffers, valid until the next run.
    """

    def __init__(self, problem: BilevelProblem, cfg: HypergradConfig,
                 hp: HParams, topo: Topology | int, *, algo: str = "mdbo",
                 mix: str = "dense", dispatch: str = "fused",
                 self_weight: float = 1.0 / 3.0,
                 mix_kwargs: dict | None = None, recorder=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(topo, Topology):
            self.K, weights = topo.size, topo.weights
        else:
            self.K, weights = int(topo), None
        if algo not in ALGORITHMS:
            raise ValueError(f"unknown algo {algo!r}; have {sorted(ALGORITHMS)}")
        if dispatch not in ("fused", "per_step"):
            raise ValueError(f"dispatch must be fused|per_step, got {dispatch!r}")
        self.problem, self.cfg, self.hp = problem, cfg, hp
        self.algo, self.mix_name, self.dispatch = algo, mix, dispatch
        mk = dict(mix_kwargs or {})
        self.mix = make_mix(mix, weights=weights, K=self.K,
                            self_weight=self_weight, device=self.device, **mk)
        self.recorder = NullRecorder() if recorder is None else recorder
        # static inputs of the obs bytes-per-mix-round count
        self._weights = weights
        self._mix_ratio = float(mk.get("ratio", 1.0))
        self._mix_stateful = bool(getattr(self.mix, "stateful", False))
        alg = ALGORITHMS[algo]
        self._init_body = partial(alg.init, problem, cfg, hp, self.mix)
        self._step_nomix = partial(alg.step, problem, cfg, hp)
        self._graphs: dict = {}
        self._obs = None    # (MetricSet, accumulators), built on first use
        self.mix_states: tuple = ()
        self.captures = 0   # CUDA graphs captured
        self.capture_s = 0.0  # their seconds, warm-up step included
        self.replays = 0    # CUDA graph replays (one per fused chunk)

    # -- building blocks ----------------------------------------------------

    def init(self, X0: Tree, Y0: Tree, batch, jtilde) -> Tree:
        """Iteration t = 0: init(X0, Y0, batch, jtilde) -> state. A stateful
        mix runs its stateless form (no history yet)."""
        return self._init_body(X0, Y0, batch, jtilde)

    def step(self, carry: Tree, batch, jtilde, deliveries=None) -> Tree:
        """One iteration t ≥ 1: step(carry, batch, jtilde) -> carry. The
        carry is the algorithm state, or ``(state, mix_states)`` for a
        stateful mix, whose per-site slots are rebound each step in call
        order; ``deliveries`` is the step's draw of a mix that draws."""
        if not self._mix_stateful:
            return self._step_nomix(self.mix, carry, batch, jtilde)
        state, mstates = carry
        mix, out = self.mix.bind(mstates, deliveries)
        new = self._step_nomix(mix, state, batch, jtilde)
        return new, tuple(out)

    def _carry_state(self, carry: Tree) -> Tree:
        return carry[0] if self._mix_stateful else carry

    def _mix_sites(self, state: Tree, batch, jtilde) -> list:
        """The trees one step mixes, in call order, as ``meta`` tensors of
        their shapes and dtypes: the step runs once on ``meta`` copies of
        its inputs with a mix that records what it is given, so no
        arithmetic runs at any width (the problem's losses must therefore
        hold no tensor of their own). Shared by the stateful-mix slots and
        the obs bytes-per-round metric."""
        sites: list = []

        def probe(tree):
            sites.append(tree)
            return tree

        meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                        (state, batch, jtilde))
        self._step_nomix(probe, *meta)
        return sites

    def _obs_metrics(self, state: Tree, sites: list):
        """The trainer MetricSet and its accumulators on the device, built
        once (a captured chunk adds into these very tensors)."""
        if self._obs is None:
            mset = trainer_metric_set(state, mix=self.mix, mix_sites=sites,
                                      ratio=self._mix_ratio,
                                      weights=self._weights)
            self._obs = (mset, mset.init(self.device))
        return self._obs

    def evaluate(self, state: Tree, eval_batch) -> dict:
        """{upper, lower, cx, cy} at the node-mean parameters."""
        xbar, ybar = node_mean(state.x), node_mean(state.y)
        return {
            "upper": self.problem.upper_loss(xbar, ybar, eval_batch),
            "lower": self.problem.lower_loss(xbar, ybar, eval_batch),
            "cx": consensus_error(state.x),
            "cy": consensus_error(state.y),
        }

    def _chunk(self, carry: Tree, draws: list, *, in_place: bool = False,
               macc: dict | None = None):
        """``len(draws)`` steps and each step's consensus errors, ``[n,
        2]``: the body a fused chunk runs (and captures on CUDA).
        ``in_place`` copies each step's new carry into ``carry``'s tensors
        (the captured chunk, whose input is its output) and frees it before
        the next step; the values are the same. ``macc``: obs accumulators
        that each step adds into."""
        trace = []
        for d in draws:
            new = self.step(carry, *d)
            if macc is not None:
                self._obs[0].update(macc, {
                    "old": self._carry_state(carry),
                    "new": self._carry_state(new),
                    "mix_states": new[1] if self._mix_stateful else None})
            if in_place:
                _copy_into(carry, new)
                del new
            else:
                carry = new
            s = self._carry_state(carry)
            trace.append(torch.stack([consensus_error(s.x),
                                      consensus_error(s.y)]))
        return carry, torch.stack(trace)

    def run_chunk(self, carry: Tree, draws: list, macc: dict | None = None):
        """Fused dispatch of ``len(draws)`` steps, each draw a ``(batch,
        jtilde[, deliveries])`` tuple on the engine's device: one CUDA graph
        replay on the card (captured on the first chunk of this length),
        the plain loop on the CPU. Returns ``(carry, trace)``; on CUDA both
        are the graph's static buffers, which the next replay overwrites.
        The chunk that captures a graph adopts ``carry``'s tensors (and
        ``macc``'s) as those buffers."""
        if self.device.type != "cuda":
            return self._chunk(carry, draws, macc=macc)
        key = (len(draws), _layout(draws[0]), _layout(carry), macc is None)
        graph = self._graphs.get(key)
        if graph is None:
            t0 = time.perf_counter()
            graph = self._graphs[key] = ChunkGraph(self._chunk, carry, draws,
                                                   macc)
            torch.cuda.synchronize()
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
        self.replays += 1
        return graph.replay(carry, draws)

    def _to_device(self, tree: Tree) -> Tree:
        return tree_map(lambda a: torch.as_tensor(a).to(self.device), tree)

    # -- the run loop -------------------------------------------------------

    def run(self, sample_batch: Callable | Sampler, eval_batch: Any,
            steps: int, seed: int = 0, eval_every: int = 10,
            init_batch_scale: int = 1,
            extra_metrics: Callable[[Any, Any], dict] | None = None,
            x0: Any | None = None, y0: Any | None = None,
            return_state: bool = False,
            on_eval: Callable[[int, Any], None] | None = None,
            jtilde=None) -> RunResult:
        """Run the configured algorithm for ``steps`` iterations.

        sample_batch is a :class:`Sampler` or bare callable taking the
        engine's batch generator and returning {'f','g','h'} with node axis
        K (and J axis on 'h'); it is called for the init batch first, then
        for steps 1 … ``steps`` in order, whatever the dispatch. eval_batch
        is a *global* batch for diagnostics. ``on_eval(t, state)`` fires
        after every recorded eval boundary (t=0 included); under fused
        dispatch on CUDA its state is the graph's buffers, valid until the
        next chunk. ``return_state`` also returns the final algorithm state
        (a copy).

        ``jtilde``: an optional pre-drawn J̃ schedule, ``[steps + 1, K]``
        integers in ``{0..J-1}`` (row 0 for the init step), used in place of
        the engine's own J̃ generator. It exists so that tests can hand the
        port the JAX package's draws, and so that a CPU and a CUDA run can be
        compared on the same J̃; runs leave it ``None``.
        """
        del init_batch_scale  # accepted for API compatibility
        K, dev = self.K, self.device
        s_init, s_batch, s_jt = _seeds(seed)
        gen_init = torch.Generator().manual_seed(s_init)
        gen_batch = torch.Generator(device=dev).manual_seed(s_batch)
        gen_jt = torch.Generator().manual_seed(s_jt)
        if jtilde is not None:
            jtilde = torch.as_tensor(np.asarray(jtilde), dtype=torch.int64)
            if tuple(jtilde.shape) != (steps + 1, K):
                raise ValueError(f"jtilde schedule must be [steps + 1, K] = "
                                 f"[{steps + 1}, {K}], got "
                                 f"{list(jtilde.shape)}")
            if jtilde.numel() and not (0 <= int(jtilde.min())
                                       and int(jtilde.max()) < self.cfg.J):
                raise ValueError(f"jtilde schedule must lie in "
                                 f"{{0..{self.cfg.J - 1}}}")
        deliveries = None

        def draw(t):
            """Step t's (batch, J̃[, deliveries]) on the device; t = 0 is
            the init step, which draws no deliveries."""
            batch = self._to_device(sample_batch(gen_batch))
            jt = (draw_jtilde(self.cfg, (K,), gen_jt) if jtilde is None
                  else jtilde[t])
            if t == 0 or deliveries is None:
                return batch, jt.to(dev)
            return batch, jt.to(dev), deliveries().to(dev)

        if x0 is None:
            x0 = self.problem.init_x(gen_init, dev)
        if y0 is None:
            y0 = self.problem.init_y(gen_init, dev)
        X0 = replicate(self._to_device(x0), K)
        Y0 = replicate(self._to_device(y0), K)
        eval_batch = self._to_device(eval_batch)

        b0, jt0 = draw(0)
        state = self.init(X0, Y0, b0, jt0)
        # what the state does not hold goes back to the allocator now: at
        # full LM width each of X0/Y0 and y0 is gigabytes
        del x0, y0, X0, Y0
        fused = self.dispatch == "fused"
        rec = self.recorder
        # the trainer metrics ride the fused chunk only; per_step records
        # the eval-boundary gauges alone, as the JAX package's does
        obs = fused and rec.enabled
        sites = (self._mix_sites(state, b0, jt0)
                 if self._mix_stateful or obs else [])
        carry = state
        if self._mix_stateful:
            carry = (state, tuple(self.mix.state0(site, i)
                                  for i, site in enumerate(sites)))
            if hasattr(self.mix, "draws"):
                deliveries = self.mix.draws(len(sites))
        del b0, jt0, state
        mset = macc = None
        if obs:
            mset, macc = self._obs_metrics(self._carry_state(carry), sites)
            mset.reset(macc)
        res = RunResult(self.algo, [], [], [], [], [], {})
        t0 = time.perf_counter()

        def record(t, state, trace=None):
            with rec.span("eval", step=t):
                m = self.evaluate(state, eval_batch)
                upper, lower, cx, cy = torch.stack(
                    [m["upper"], m["lower"], m["cx"], m["cy"]]).tolist()
                res.steps.append(t)
                res.upper_loss.append(upper)
                res.lower_loss.append(lower)
                res.consensus_x.append(cx)
                res.consensus_y.append(cy)
                if fused:
                    # in-chunk diagnostics: chunk-mean consensus
                    scx, scy = ((cx, cy) if trace is None
                                else trace.mean(dim=0).tolist())
                    res.extra.setdefault("scan_cx_mean", []).append(scx)
                    res.extra.setdefault("scan_cy_mean", []).append(scy)
                extras = (extra_metrics(state, eval_batch)
                          if extra_metrics is not None else {})
                for k, v in extras.items():
                    res.extra.setdefault(k, []).append(float(v))
                if rec.enabled:
                    rec.metrics({"eval_upper_loss": upper,
                                 "eval_lower_loss": lower,
                                 "eval_consensus_x": cx,
                                 "eval_consensus_y": cy,
                                 **{f"eval_{k}": float(v)
                                    for k, v in extras.items()}}, step=t)
                if on_eval is not None:
                    on_eval(t, state)

        record(0, self._carry_state(carry))

        if not fused:
            for t in range(1, steps + 1):
                carry = self.step(carry, *draw(t))
                if t % eval_every == 0 or t == steps:
                    rec.counter_add("train_steps", eval_every
                                    if t % eval_every == 0 else t % eval_every)
                    record(t, self._carry_state(carry))
        else:
            t = 0
            while t < steps:
                n = min(eval_every, steps - t)
                with rec.span("train_chunk", t0=t, steps=n):
                    draws = [draw(t + i) for i in range(1, n + 1)]
                    carry, trace = self.run_chunk(carry, draws, macc)
                t += n
                rec.counter_add("train_steps", n)
                if obs:
                    # drain at the chunk boundary (the host is already
                    # syncing for the eval record below) and reset the
                    # accumulators for the next chunk
                    rec.record_drain(mset.drain(macc), step=t)
                    mset.reset(macc)
                record(t, self._carry_state(carry), trace)

        res.wall_time_s = time.perf_counter() - t0
        self.mix_states = carry[1] if self._mix_stateful else ()
        if rec.enabled:
            rec.event("run_done", algo=self.algo, steps=steps,
                      wall_time_s=res.wall_time_s)
            rec.flush()
        if return_state:
            return res, tree_map(torch.clone, self._carry_state(carry))
        return res
