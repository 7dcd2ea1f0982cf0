"""Execution engine of the decentralized bilevel run: algorithm × mix
backend × dispatch, on one device.

The counterpart of ``repro.core.engine``:

* **Dispatch** — ``per_step`` runs one eager step per call. ``fused`` runs
  an eval interval (``eval_every`` steps) as one unit, the counterpart of
  the JAX package's ``lax.scan`` chunk: on CUDA the interval is **one CUDA
  graph replay**. The graph is captured once per chunk length (and batch
  layout) and cached; it works on static state, batch and J̃ buffers. The
  chunk's batches and J̃ are drawn on the host before the replay, step by
  step in the order per-step dispatch draws them, and copied into the
  static buffers, so no random draw happens inside the graph. The capture
  is warmed up on a copy of the state, so the warm-up never advances the
  real run. On the CPU, ``fused`` is the same plain loop. Either way a fused
  run equals a per-step run bit for bit (the same kernels on the same
  inputs in the same order), and a failed capture or replay fails the run:
  nothing falls back to eager dispatch.
* **Mix backends** — a registry of the communication primitive
  ``A ↦ W A``: ``dense`` (contraction with the K×K mixing matrix) and
  ``ring_rolled`` (``torch.roll``, W-free). The JAX package's
  ``ring_local``, ``compressed_*`` and ``async_gossip`` backends are not
  ported yet (``ROADMAP.md``, queue 1, item 6): :func:`make_mix` raises
  ``NotImplementedError`` for them.
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
from repro_torch.core.common import (HParams, consensus_error, node_mean,
                                     replicate)
from repro_torch.core.hypergrad import (HypergradConfig, draw_jtilde,
                                        tree_map, tree_zeros_like)
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.topology import Topology, ring
from repro_torch.core.tracking import (MixFn, dense_mix, param_update,
                                       ring_mix_rolled, track_update)
from repro_torch.device import resolve_device
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
    a2 = hp.alpha2 * hp.eta
    v_new = tree_map(lambda v, d: (1 - a2) * v + a2 * d, state.v, dg)
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

# the JAX package's other backends, not ported yet
NOT_PORTED_MIXES = ("ring_local", "compressed_topk", "compressed_rand",
                    "async_gossip")


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


def make_mix(name: str, **kwargs) -> MixFn:
    """Build a mixing operator from the backend registry.

    kwargs: weights (dense), K (default-ring fallback), self_weight, device
    (``"cuda"`` unless the caller names another: without a card the default
    raises, as every entry point's does).
    """
    if name in NOT_PORTED_MIXES:
        raise NotImplementedError(
            f"mix={name!r}: the port has the 'dense' and 'ring_rolled' "
            "backends only (ROADMAP.md, queue 1, item 6: the remaining mix "
            "backends)")
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
    adopts the given state's tensors as that buffer. Both keep the card's
    memory at what a per-step run needs (66 GB for MDBO on full-width
    ``smollm-360m`` at K = 4, of which a state is 17). ``trace`` holds each
    step's (consensus_x, consensus_y).
    """

    def __init__(self, chunk: Callable, state: Tree, draws: list):
        clone = partial(tree_map, torch.clone)
        self.state = _unaliased(state)
        self.batches = [clone(b) for b, _ in draws]
        self.jtildes = [jt.clone() for _, jt in draws]
        # warm up (one step: the chunk repeats one step's kernels) on a side
        # stream, as torch.cuda.graph asks; a step writes nothing it reads,
        # so the warm-up advances nothing real
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chunk(self.state, self.batches[:1], self.jtildes[:1])
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _, self.trace = chunk(self.state, self.batches, self.jtildes,
                                  in_place=True)

    def replay(self, state: Tree, draws: list):
        _copy_into(self.state, state)
        for (b, jt), sb, sj in zip(draws, self.batches, self.jtildes):
            _copy_into(sb, b)
            sj.copy_(jt)
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
    topo: a :class:`Topology` (its W feeds the dense backend) or a bare node
        count K.
    algo: one of :data:`ALGORITHMS`.
    mix: one of :data:`MIX_BACKENDS`.
    dispatch: ``fused`` (an eval interval per CUDA graph replay on the card,
        a plain loop on the CPU) or ``per_step`` (one eager step per call).
    device: ``"cuda"`` (the default) or ``"cpu"``; without a card the
        default raises (:func:`repro_torch.device.resolve_device`).
    """

    def __init__(self, problem: BilevelProblem, cfg: HypergradConfig,
                 hp: HParams, topo: Topology | int, *, algo: str = "mdbo",
                 mix: str = "dense", dispatch: str = "fused",
                 self_weight: float = 1.0 / 3.0, recorder=None,
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
        self.mix = make_mix(mix, weights=weights, K=self.K,
                            self_weight=self_weight, device=self.device)
        self.recorder = NullRecorder() if recorder is None else recorder
        alg = ALGORITHMS[algo]
        self._init_body = partial(alg.init, problem, cfg, hp, self.mix)
        self._step_body = partial(alg.step, problem, cfg, hp, self.mix)
        self._graphs: dict = {}
        self.captures = 0   # CUDA graphs captured
        self.capture_s = 0.0  # their seconds, warm-up step included
        self.replays = 0    # CUDA graph replays (one per fused chunk)

    # -- building blocks ----------------------------------------------------

    def init(self, X0: Tree, Y0: Tree, batch, jtilde) -> Tree:
        """Iteration t = 0: init(X0, Y0, batch, jtilde) -> state."""
        return self._init_body(X0, Y0, batch, jtilde)

    def step(self, state: Tree, batch, jtilde) -> Tree:
        """One iteration t ≥ 1: step(state, batch, jtilde) -> state."""
        return self._step_body(state, batch, jtilde)

    def evaluate(self, state: Tree, eval_batch) -> dict:
        """{upper, lower, cx, cy} at the node-mean parameters."""
        xbar, ybar = node_mean(state.x), node_mean(state.y)
        return {
            "upper": self.problem.upper_loss(xbar, ybar, eval_batch),
            "lower": self.problem.lower_loss(xbar, ybar, eval_batch),
            "cx": consensus_error(state.x),
            "cy": consensus_error(state.y),
        }

    def _chunk(self, state: Tree, batches: list, jtildes: list, *,
               in_place: bool = False):
        """``len(batches)`` steps and each step's consensus errors,
        ``[n, 2]``: the body a fused chunk runs (and captures on CUDA).
        ``in_place`` copies each step's new state into ``state``'s tensors
        (the captured chunk, whose input is its output) and frees it before
        the next step; the values are the same."""
        trace = []
        for batch, jt in zip(batches, jtildes):
            new = self.step(state, batch, jt)
            if in_place:
                _copy_into(state, new)
                del new
            else:
                state = new
            trace.append(torch.stack([consensus_error(state.x),
                                      consensus_error(state.y)]))
        return state, torch.stack(trace)

    def run_chunk(self, state: Tree, draws: list):
        """Fused dispatch of ``len(draws)`` steps, each draw a ``(batch,
        jtilde)`` pair on the engine's device: one CUDA graph replay on the
        card (captured on the first chunk of this length), the plain loop on
        the CPU. Returns ``(state, trace)``; on CUDA both are the graph's
        static buffers, which the next replay overwrites. The chunk that
        captures a graph adopts ``state``'s tensors as those buffers."""
        if self.device.type != "cuda":
            return self._chunk(state, [b for b, _ in draws],
                               [jt for _, jt in draws])
        key = (len(draws), _layout(draws[0][0]), _layout(state))
        graph = self._graphs.get(key)
        if graph is None:
            t0 = time.perf_counter()
            graph = self._graphs[key] = ChunkGraph(self._chunk, state, draws)
            torch.cuda.synchronize()
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
        self.replays += 1
        return graph.replay(state, draws)

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
        next chunk.

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

        def draw(t):
            """Step t's (batch, J̃) on the device; t = 0 is the init step."""
            batch = self._to_device(sample_batch(gen_batch))
            jt = (draw_jtilde(self.cfg, (K,), gen_jt) if jtilde is None
                  else jtilde[t])
            return batch, jt.to(dev)

        if x0 is None:
            x0 = self.problem.init_x(gen_init, dev)
        if y0 is None:
            y0 = self.problem.init_y(gen_init, dev)
        X0 = replicate(self._to_device(x0), K)
        Y0 = replicate(self._to_device(y0), K)
        eval_batch = self._to_device(eval_batch)

        state = self.init(X0, Y0, *draw(0))
        # what the state does not hold goes back to the allocator now: at
        # full LM width each of X0/Y0 and y0 is gigabytes
        del x0, y0, X0, Y0
        fused = self.dispatch == "fused"
        rec = self.recorder
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

        record(0, state)

        if not fused:
            for t in range(1, steps + 1):
                state = self.step(state, *draw(t))
                if t % eval_every == 0 or t == steps:
                    rec.counter_add("train_steps", eval_every
                                    if t % eval_every == 0 else t % eval_every)
                    record(t, state)
        else:
            t = 0
            while t < steps:
                n = min(eval_every, steps - t)
                with rec.span("train_chunk", t0=t, steps=n):
                    draws = [draw(t + i) for i in range(1, n + 1)]
                    state, trace = self.run_chunk(state, draws)
                t += n
                rec.counter_add("train_steps", n)
                record(t, state, trace)

        res.wall_time_s = time.perf_counter() - t0
        if rec.enabled:
            rec.event("run_done", algo=self.algo, steps=steps,
                      wall_time_s=res.wall_time_s)
            rec.flush()
        if return_state:
            return res, tree_map(torch.clone, state)
        return res
