"""Decentralized bilevel LM training — thin adapters over the Engine.

Maps a :class:`TrainerConfig` and a :class:`ModelConfig` onto
:class:`repro_torch.core.engine.Engine` (:func:`make_trainer_engine`); the
Engine's per-step or CUDA-graph-fused dispatch, mix backends and seeded
generators drive the run (``repro_torch.launch.train`` is a plain
``Engine.run`` caller). K nodes, each holding its own (x, θ) copy, are a
leading node axis on one device: the JAX package's ``dp`` placement without
a mesh.

The counterpart of ``repro.train.decentral``. The node-placement policy
(:func:`n_nodes`, :func:`node_axis_name`: ``dp`` puts K = the ``data``
axis's participants on ``data``, ``fsdp_gt`` K = pods on ``pod``) reads a
:class:`repro_torch.launch.mesh.Mesh`, and the dry-run helpers
(:func:`state_shape`, :func:`step_batch_specs`, :func:`node_keys_spec`)
give the step's inputs as ``meta`` tensors, shapes and dtypes without
storage (:mod:`repro_torch.launch.dryrun`). Running the Engine over a mesh
(``make_trainer_engine(mesh=)``, one node per process) is not ported
(``ROADMAP.md``, queue 1, item 6).

Algorithms come from the Engine registry: 'mdbo' (Alg. 1), 'vrdbo' (Alg. 2)
and 'gt_sgd' — single-level gradient-tracking SGD ablation.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.core import mdbo, vrdbo
from repro_torch.core.common import HParams
from repro_torch.core.engine import ALGORITHMS, Engine
from repro_torch.core.engine import make_mix as make_engine_mix
from repro_torch.core.hypergrad import HypergradConfig, tree_map
from repro_torch.data.lm import (lm_batch_extras, make_lm_step_batch,
                                 make_node_batch)
from repro_torch.models.config import ModelConfig
from repro_torch.train.bilevel_lm import make_lm_bilevel_problem

__all__ = ["TrainerConfig", "lm_batch_extras", "make_mix", "make_node_batch",
           "make_problem", "make_step_batch", "make_step_fns",
           "make_trainer_engine", "n_nodes", "node_axis_name",
           "node_keys_spec", "state_shape", "step_batch_specs"]

_MESH = ("running the trainer over a device mesh (one node per process) "
         "waits on ROADMAP.md, queue 1, item 6 (ring_local over "
         "torch.distributed)")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    algo: str = "mdbo"            # mdbo | vrdbo | gt_sgd
    J: int = 2                    # Neumann terms at LM scale (logreg uses 10)
    mix: str = "dense"            # engine mix backend ('ring' = ring_rolled)
    hp: HParams = dataclasses.field(default_factory=lambda: HParams(
        eta=0.1, alpha1=1.0, alpha2=1.0, beta1=0.05, beta2=0.5))


def n_nodes(spec, mesh) -> int:
    """K on ``mesh``: the pods for ``fsdp_gt``, the data axis for ``dp``."""
    if spec.train_mode == "fsdp_gt":
        return mesh.shape.get("pod", 1)
    return mesh.shape.get("data", 1)


def node_axis_name(spec) -> str:
    return "pod" if spec.train_mode == "fsdp_gt" else "data"


def _mix_name(tc: TrainerConfig) -> str:
    """'ring' is kept as an alias of the registry's 'ring_rolled' backend."""
    return {"ring": "ring_rolled"}.get(tc.mix, tc.mix)


def make_mix(tc: TrainerConfig, K: int, *, device="cuda"):
    """Resolve tc.mix through the engine's mix-backend registry on
    ``device``. 'dense' builds the ring-W contraction (the paper-faithful
    default); K=1 degenerates to the identity."""
    if K == 1:
        return lambda tree: tree
    return make_engine_mix(_mix_name(tc), K=K, device=device)


def make_problem(model_cfg: ModelConfig, tc: TrainerConfig):
    """(BilevelProblem, HypergradConfig) for the LM regularization problem."""
    problem = make_lm_bilevel_problem(model_cfg)
    hcfg = HypergradConfig(J=tc.J, lip_gy=problem.lip_gy, randomize=True)
    return problem, hcfg


def make_trainer_engine(model_cfg: ModelConfig, tc: TrainerConfig, K: int, *,
                        mesh=None, dispatch: str = "fused",
                        mix: str | None = None,
                        mix_kwargs: dict | None = None, recorder=None,
                        device="cuda"):
    """Build the Engine that runs the decentralized LM trainer on
    ``device``: ``(problem, engine)``. ``mix`` overrides ``tc.mix`` (a
    registry name) and ``mix_kwargs`` are passed to the backend (e.g.
    ``mix='async_gossip', mix_kwargs={'tau': t, 'drop_prob': p}``, or
    ``mix='compressed_topk', mix_kwargs={'ratio': r, 'error_feedback':
    True}``). ``mesh`` is not ported."""
    if mesh is not None:
        raise NotImplementedError(f"make_trainer_engine(mesh=): {_MESH}")
    problem, hcfg = make_problem(model_cfg, tc)
    eng = Engine(problem, hcfg, tc.hp, K, algo=tc.algo,
                 mix=mix or _mix_name(tc), dispatch=dispatch,
                 mix_kwargs=mix_kwargs, recorder=recorder, device=device)
    return problem, eng


def make_step_fns(model_cfg: ModelConfig, tc: TrainerConfig):
    """(problem, init_fn, step_fn) over node-stacked state, pulled from the
    Engine's algorithm registry; both take the mix first:
    ``init_fn(mix, X0, Y0, batch, jtilde)``, ``step_fn(mix, state, batch,
    jtilde)``."""
    problem, hcfg = make_problem(model_cfg, tc)
    if tc.algo not in ALGORITHMS:
        raise ValueError(tc.algo)
    alg = ALGORITHMS[tc.algo]
    init = partial(alg.init, problem, hcfg, tc.hp)
    step = partial(alg.step, problem, hcfg, tc.hp)
    return problem, init, step


def make_step_batch(cfg: ModelConfig, tc: TrainerConfig,
                    generator: torch.Generator, K: int, per_node: int,
                    seq: int):
    """{'f','g','h'} with node axis K — see data.make_lm_step_batch."""
    return make_lm_step_batch(cfg, generator, K, per_node, seq, J=tc.J)


def _meta(t: torch.Tensor, lead: tuple = ()) -> torch.Tensor:
    return torch.empty(lead + tuple(t.shape), dtype=t.dtype, device="meta")


def step_batch_specs(cfg: ModelConfig, tc: TrainerConfig, K: int,
                     per_node: int, seq: int) -> dict:
    """:func:`make_step_batch`'s tree as ``meta`` tensors: 'f' and 'g'
    leaves ``[K, per_node, ...]``, 'h' leaves ``[K, J, per_node, ...]``.
    Every leaf's trailing shape and dtype come from one real draw of a
    single row (the CPU, one node), so they are the sampler's own."""
    row = make_step_batch(cfg, tc, torch.Generator().manual_seed(0), 1, 1,
                          seq)
    lead = {"f": (K, per_node), "g": (K, per_node),
            "h": (K, tc.J, per_node)}
    return {k: {n: _meta(t[(0,) * len(lead[k])], lead[k])
                for n, t in leaves.items()}
            for k, leaves in row.items()}


def node_keys_spec(K: int) -> torch.Tensor:
    """The per-node randomness the port's step takes: J̃, int64 ``[K]``
    (``meta``), one truncation level per node, drawn outside the step
    (:func:`repro_torch.core.hypergrad.draw_jtilde`). The JAX step takes
    ``(K, 2)`` uint32 PRNG keys instead and draws J̃ inside: 8·K bytes
    either way (32 at K = 4)."""
    return torch.empty((K,), dtype=torch.int64, device="meta")


def state_shape(cfg: ModelConfig, tc: TrainerConfig, K: int):
    """The MDBO state after ``init`` (the VRDBO state for
    ``tc.algo == "vrdbo"``; x, y and their trackers, each with node axis
    K) as ``meta`` tensors, allocating nothing: the
    problem's ``init_x``/``init_y`` run on fake tensors and only their
    shapes and dtypes are kept."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    problem = make_lm_bilevel_problem(cfg)
    with FakeTensorMode():
        gen = torch.Generator().manual_seed(0)
        x0, y0 = problem.init_x(gen, "cpu"), problem.init_y(gen, "cpu")
    x = _meta(x0, (K,))
    y = tree_map(lambda a: _meta(a, (K,)), y0)
    if tc.algo == "vrdbo":
        return vrdbo.VRDBOState(x=x, y=y, x_prev=x, y_prev=y, u=x, v=y,
                                zf=x, zg=y)
    return mdbo.MDBOState(x=x, y=y, u=x, v=y, zf=x, zg=y)
