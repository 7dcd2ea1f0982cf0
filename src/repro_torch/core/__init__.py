"""repro_torch.core — the paper's decentralized bilevel run in PyTorch, the
counterpart of ``repro.core``.

Public surface:
  topology.{ring,torus2d,complete,star,get,Topology}
  problems.{BilevelProblem,quadratic_problem,logreg_hyperopt}
  hypergrad.{HypergradConfig,stochastic_hypergrad,expected_hypergrad}
  common.HParams, driver.run
  engine.{Engine,ALGORITHMS,MIX_BACKENDS,make_mix} — the run substrate
    behind driver.run (per-step or CUDA-graph-fused dispatch)
  mdbo / vrdbo / baselines step functions
  tracking.{dense_mix,ring_mix_rolled}
  compression.{topk_sparsify,random_sparsify,compressed_mix,ErrorFeedbackMix}
  async_gossip.{AsyncGossipMix,expected_staleness}

Not ported yet (``ROADMAP.md``, queue 1, item 6): ``distributed``,
``ring_mix_local`` and ``ring_wmi_local``.
"""
from repro_torch.core import (async_gossip, baselines, compression, engine,
                              mdbo, topology, tracking, vrdbo)
from repro_torch.core.common import (HParams, consensus_error, node_mean,
                                     replicate)
from repro_torch.core.driver import ALGOS, run
from repro_torch.core.engine import (ALGORITHMS, MIX_BACKENDS, Engine,
                                     RunResult, make_mix)
from repro_torch.core.hypergrad import (HypergradConfig, expected_hypergrad,
                                        stochastic_hypergrad)
from repro_torch.core.problems import (BilevelProblem, accuracy,
                                       logreg_hyperopt, quadratic_problem)
from repro_torch.core.topology import (Topology, complete, get, ring, star,
                                       torus2d)
from repro_torch.core.tracking import dense_mix, ring_mix_rolled

__all__ = [
    "ALGORITHMS", "ALGOS", "BilevelProblem", "Engine", "HParams",
    "HypergradConfig", "MIX_BACKENDS", "RunResult", "Topology", "accuracy",
    "async_gossip", "baselines", "complete", "compression", "consensus_error", "dense_mix", "engine",
    "expected_hypergrad", "get", "logreg_hyperopt", "make_mix", "mdbo",
    "node_mean", "quadratic_problem", "replicate", "ring", "ring_mix_rolled",
    "run", "star", "stochastic_hypergrad", "topology", "torus2d", "tracking",
    "vrdbo",
]
