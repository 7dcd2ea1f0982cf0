"""Algorithm driver: uniform run-loop over MDBO / VRDBO / DSBO / GDSBO.

A thin façade over :class:`repro_torch.core.engine.Engine`, the counterpart
of ``repro.core.driver``: by default every eval interval runs as one CUDA
graph replay (``dispatch="fused"``); pass ``dispatch="per_step"`` for one
eager step per call and ``mix_backend`` to pick a communication backend.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.common import HParams
from repro_torch.core.engine import ALGORITHMS, Engine, RunResult
from repro_torch.core.hypergrad import HypergradConfig
from repro_torch.core.problems import BilevelProblem
from repro_torch.core.topology import Topology

# The paper's algorithms (benchmarks/tests parametrize over these). The
# engine registry additionally carries the single-level 'gt_sgd' ablation.
ALGOS = ("mdbo", "vrdbo", "dsbo", "gdsbo")


def run(problem: BilevelProblem, cfg: HypergradConfig, hp: HParams,
        topo: Topology, algo: str,
        sample_batch: Callable[[Any], Any],
        eval_batch: Any,
        steps: int, seed: int = 0, eval_every: int = 10,
        init_batch_scale: int = 1,
        extra_metrics: Callable[[Any, Any], dict] | None = None,
        x0: Any | None = None, y0: Any | None = None, *,
        dispatch: str = "fused", mix_backend: str = "dense",
        device="cuda") -> RunResult:
    """Run ``algo`` for ``steps`` iterations on ``problem`` over ``topo``.

    sample_batch(generator) must return {'f','g','h'} with node axis K (and
    J axis on 'h'). eval_batch is a *global* batch (no node axis) for
    diagnostics.
    """
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown algo {algo!r}; have {sorted(ALGORITHMS)}")
    eng = Engine(problem, cfg, hp, topo, algo=algo, mix=mix_backend,
                 dispatch=dispatch, device=device)
    return eng.run(sample_batch, eval_batch, steps=steps, seed=seed,
                   eval_every=eval_every, init_batch_scale=init_batch_scale,
                   extra_metrics=extra_metrics, x0=x0, y0=y0)
