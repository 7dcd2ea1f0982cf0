"""The port's compressed and asynchronous gossip on the card: fused
dispatch (one CUDA graph replay per chunk) against per-step dispatch, bit
for bit with every mix slot, with and without a live recorder, and the
card against the CPU on the same batches, J̃ and deliveries. JAX-free, so
it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_gossip_cuda.py

Every test skips without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.core import (Engine, HParams, HypergradConfig,  # noqa: E402
                              logreg_hyperopt, ring)
from repro_torch.data import (NodeSampler, make_classification,  # noqa: E402
                              shard_to_nodes, train_val_split)
from repro_torch.obs import Recorder  # noqa: E402

K, D, J, B, EVAL, SEED = 4, 16, 4, 8, 5, 0
HP = {"vrdbo": HParams(0.33, 5.0, 5.0, 1.0, 1.0)}
BACKENDS = {
    "topk": ("compressed_topk", {"ratio": 0.25}),
    "topk-ef": ("compressed_topk", {"ratio": 0.25, "error_feedback": True}),
    "rand": ("compressed_rand", {"ratio": 0.5, "seed": 3}),
    "rand-ef": ("compressed_rand", {"ratio": 0.25, "error_feedback": True}),
    "async": ("async_gossip", {"tau": 3, "drop_prob": 0.4, "seed": 5}),
    "async-ef": ("async_gossip", {"tau": 2, "drop_prob": 0.3,
                                  "error_feedback": True, "ratio": 0.25}),
}
# the card against the CPU, TF32 off: the same f32 ops summed in other
# orders, as tests/test_torch_bilevel_cuda.py's limit, on the losses and on
# each state leaf relative to its largest entry when that exceeds 1 (the
# unbiased random mask's 1/ratio rescale grows y, and its rounding, ~15x in
# 13 steps); top-k's gaps at these sizes (4 or 8 of 16 or 32 entries a
# node) are far wider
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def run(algo, mix, mk, dispatch, device, steps=13, recorder=None):
    eng = Engine(logreg_hyperopt(d=D, lip_gy=5.0),
                 HypergradConfig(J=J, lip_gy=5.0), HP.get(algo, HParams()),
                 ring(K), algo=algo, mix=mix, mix_kwargs=mk,
                 dispatch=dispatch, recorder=recorder, device=device)
    ds = make_classification(n=600, d=D, c=2, seed=SEED)
    tr, va = train_val_split(ds, 0.3, seed=SEED)
    smp = NodeSampler(shard_to_nodes(tr, K), shard_to_nodes(va, K), batch=B,
                      J=J, seed=SEED)
    jt = np.random.default_rng(SEED).integers(0, J, (steps + 1, K))
    res, state = eng.run(smp, smp.eval_batch(), steps=steps, seed=SEED,
                         eval_every=EVAL, return_state=True, jtilde=jt)
    return eng, res, state


def leaves(eng, state):
    return pytree.tree_leaves((state, eng.mix_states))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_fused_graph_replays_equal_per_step_bitwise(cuda_device, algo,
                                                    backend):
    """13 steps: a graph of 5 steps replayed twice and one of 3; every mix
    slot is equal at the end; a live recorder changes no number."""
    pe, rp, sp = run(algo, *BACKENDS[backend], "per_step", cuda_device)
    fe, rf, sf = run(algo, *BACKENDS[backend], "fused", cuda_device)
    assert (fe.captures, fe.replays) == (2, 3)
    assert rp.upper_loss == rf.upper_loss
    assert rp.consensus_y == rf.consensus_y
    assert all(torch.equal(a, b) for a, b in zip(leaves(pe, sp),
                                                 leaves(fe, sf)))
    rec = Recorder()
    oe, ro, so = run(algo, *BACKENDS[backend], "fused", cuda_device,
                     recorder=rec)
    assert ro.upper_loss == rf.upper_loss
    assert all(torch.equal(a, b) for a, b in zip(leaves(oe, so),
                                                 leaves(fe, sf)))
    snap = rec.snapshot()
    assert snap["counters"]["train_steps"] == 13
    if backend.startswith("async"):
        assert sum(snap["hist_counts"]["train_staleness"]) == 13 * 4 * 2 * K


@pytest.mark.cuda
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_card_matches_cpu(cuda_device, backend):
    """The same batches, J̃ and deliveries (host streams) on both."""
    ce, rc, sc = run("mdbo", *BACKENDS[backend], "per_step", "cpu")
    ge, rg, sg = run("mdbo", *BACKENDS[backend], "fused", cuda_device)
    np.testing.assert_allclose(rg.upper_loss, rc.upper_loss, atol=TOL)
    np.testing.assert_allclose(rg.lower_loss, rc.lower_loss, atol=TOL)
    for a, b in zip(leaves(ge, sg), leaves(ce, sc)):
        b = b.float().numpy()
        np.testing.assert_allclose(a.cpu().float().numpy(), b, rtol=0,
                                   atol=TOL * max(1.0, np.abs(b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_async_tau0_equals_ring_rolled_on_the_card(cuda_device, algo):
    _, ra, sa = run(algo, "async_gossip", {"tau": 0, "drop_prob": 0.7},
                    "fused", cuda_device)
    _, rr, sr = run(algo, "ring_rolled", None, "fused", cuda_device)
    assert ra.upper_loss == rr.upper_loss
    assert all(torch.equal(a, b) for a, b in zip(sa, sr))
