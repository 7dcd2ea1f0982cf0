"""The port's decentralized bilevel run on the card: fused dispatch (one
CUDA graph replay per chunk) against per-step dispatch, bit for bit, and
the card against the CPU. JAX-free, so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_bilevel_cuda.py

Every test skips without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (Engine, HParams, HypergradConfig,  # noqa: E402
                              logreg_hyperopt, ring)
from repro_torch.data import (NodeSampler, make_classification,  # noqa: E402
                              make_device_sampler, shard_to_nodes,
                              train_val_split)

K, D, J, B, EVAL, SEED = 4, 16, 4, 8, 5, 0
ALGOS = ("mdbo", "vrdbo", "dsbo", "gdsbo", "gt_sgd")
HP = {"vrdbo": HParams(0.33, 5.0, 5.0, 1.0, 1.0)}
# the card against the CPU, TF32 off: the same f32 ops summed in other
# orders (H100: ≤ 6e-8 on losses and 4e-8 on x, y at the full §6 width,
# chip_smoke.py phase 12)
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def shards():
    ds = make_classification(n=600, d=D, c=2, seed=SEED)
    tr, va = train_val_split(ds, 0.3, seed=SEED)
    return shard_to_nodes(tr, K), shard_to_nodes(va, K)


def run(algo, mix, dispatch, device, steps=13, sampler=None, engine=None):
    eng = engine or Engine(logreg_hyperopt(d=D, lip_gy=5.0),
                           HypergradConfig(J=J, lip_gy=5.0),
                           HP.get(algo, HParams()), ring(K), algo=algo,
                           mix=mix, dispatch=dispatch, device=device)
    trn, van = shards()
    smp = sampler or NodeSampler(trn, van, batch=B, J=J, seed=SEED)
    ev = NodeSampler(trn, van, batch=B, J=J).eval_batch()
    res, state = eng.run(smp, ev, steps=steps, seed=SEED, eval_every=EVAL,
                         return_state=True)
    return eng, res, state


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["dense", "ring_rolled"])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_graph_replays_equal_per_step_bitwise(cuda_device, algo, mix):
    """13 steps: a graph of 5 steps replayed twice, and one of 3 for the
    tail, each captured once (warmed up on one step)."""
    _, rp, sp = run(algo, mix, "per_step", cuda_device)
    eng, rf, sf = run(algo, mix, "fused", cuda_device)
    assert (eng.captures, eng.replays) == (2, 3)
    assert rp.upper_loss == rf.upper_loss
    assert rp.consensus_x == rf.consensus_x
    assert rp.consensus_y == rf.consensus_y
    assert all(torch.equal(a, b) for a, b in zip(sp, sf))
    assert sf.x.device.type == "cuda"
    # a second run reuses both graphs
    _, r2, _ = run(algo, mix, "fused", cuda_device, engine=eng)
    assert (eng.captures, eng.replays) == (2, 6)
    assert r2.upper_loss == rf.upper_loss


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_card_matches_cpu(cuda_device, algo):
    _, rc, sc = run(algo, "dense", "per_step", "cpu")
    _, rg, sg = run(algo, "dense", "fused", cuda_device)
    np.testing.assert_allclose(rg.upper_loss, rc.upper_loss, atol=TOL)
    np.testing.assert_allclose(rg.lower_loss, rc.lower_loss, atol=TOL)
    for a, b in zip(sg, sc):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=TOL)


@pytest.mark.cuda
def test_device_sampler_on_the_card(cuda_device):
    """The device sampler draws on the card from the engine's generator;
    per-step and fused runs draw the same batches."""
    trn, van = shards()
    smp = make_device_sampler(trn, van, batch=B, J=J, device=cuda_device)
    batch = smp(torch.Generator(device=cuda_device).manual_seed(0))
    assert batch["h"]["a"].device.type == "cuda"
    assert tuple(batch["h"]["a"].shape) == (K, J, B, D)
    _, rp, sp = run("mdbo", "dense", "per_step", cuda_device, sampler=smp)
    _, rf, sf = run("mdbo", "dense", "fused", cuda_device, sampler=smp)
    assert rp.upper_loss == rf.upper_loss
    assert all(torch.equal(a, b) for a, b in zip(sp, sf))
    assert rf.upper_loss[-1] < rf.upper_loss[0]
