"""The port's decentralized bilevel LM trainer on the card: fused dispatch
(one CUDA graph replay per chunk) against per-step dispatch, bit for bit,
and the card against the CPU, on the reduced configs (f32) of every
family; the vmapped gradient of the moe, vlm and audio families the same
on every call (the MoE dispatch and combine, the image fusion). JAX-free,
so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_trainer_cuda.py

Every test skips without a card. Full width is ``chip_smoke.py`` phases 13
(smollm-360m) and 17 (whisper-tiny).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.data import (make_device_lm_sampler,  # noqa: E402
                              make_lm_step_batch, make_node_batch)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.train import TrainerConfig, make_trainer_engine  # noqa: E402

K, B, S, STEPS, EVAL, SEED = 2, 2, 16, 5, 2, 0
NEW_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "chameleon-34b",
             "whisper-tiny")
ARCHS = ("smollm-360m", "recurrentgemma-2b", "rwkv6-1.6b") + NEW_ARCHS
# the card against the CPU, TF32 off: the same f32 ops summed in other
# orders, a few ulps a step (as chip_smoke.py phase 13's limit)
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def engine(arch, algo, dispatch, device):
    cfg = get(arch).reduced()
    tc = TrainerConfig(algo=algo, mix="ring")
    return cfg, tc, make_trainer_engine(cfg, tc, K, dispatch=dispatch,
                                       device=device)[1]


def leaves(state):
    return pytree.tree_leaves(state)


def differing(a, b):
    """(field, leaf, max |difference|, entries that differ) of every leaf
    of two states that is not bit for bit equal."""
    return [(name, i, float((p.double() - q.double()).abs().max()),
             int((p != q).sum()))
            for name, u, v in zip(a._fields, a, b)
            for i, (p, q) in enumerate(zip(leaves(u), leaves(v)))
            if not torch.equal(p, q)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo", "gt_sgd"])
def test_fused_graph_replays_equal_per_step_bitwise(cuda_device, arch, algo):
    """5 steps: a graph of 2 steps replayed twice and one of 1 for the
    tail, on the engine's own LM batches drawn on the card."""
    out, kept = {}, {}
    for dispatch in ("per_step", "fused"):
        cfg, tc, eng = engine(arch, algo, dispatch, cuda_device)
        sampler = make_device_lm_sampler(cfg, tc, K, B, S)
        ev = make_node_batch(cfg, torch.Generator(
            device=cuda_device).manual_seed(1), B, S)
        out[dispatch] = eng, eng.run(
            sampler, ev, steps=STEPS, seed=SEED, eval_every=EVAL,
            on_eval=lambda t, s: kept.setdefault((dispatch, t), pytree.tree_map(
                torch.clone, s)))
    (_, rp), (eng, rf) = out["per_step"], out["fused"]
    assert (eng.captures, eng.replays) == (2, 3)
    assert rp.upper_loss == rf.upper_loss and rp.lower_loss == rf.lower_loss
    assert rp.consensus_y == rf.consensus_y
    # every eval's state, so that a fault names the chunk it is in
    assert [(t, differing(kept["per_step", t], kept["fused", t]))
            for t in rp.steps] == [(t, []) for t in rp.steps]
    assert all(np.isfinite(rf.upper_loss))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_card_matches_cpu(cuda_device, arch, algo):
    """The same batches (drawn on the CPU) and J̃ on both devices."""
    cfg = get(arch).reduced()
    gen = torch.Generator().manual_seed(SEED)
    batches = [make_lm_step_batch(cfg, gen, K, B, S, J=2)
               for _ in range(STEPS + 1)]
    ev = make_node_batch(cfg, gen, B, S)
    jt = np.random.default_rng(SEED).integers(0, 2, (STEPS + 1, K))
    out = {}
    for device, dispatch in ((cuda_device, "fused"), ("cpu", "per_step")):
        _, _, eng = engine(arch, algo, dispatch, device)
        it = iter(batches)
        out[str(device)] = eng.run(lambda g: next(it), ev, steps=STEPS,
                                   seed=SEED, eval_every=EVAL,
                                   return_state=True, jtilde=jt)
    (rg, sg), (rc, sc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(rg.upper_loss, rc.upper_loss, atol=TOL)
    np.testing.assert_allclose(rg.lower_loss, rc.lower_loss, atol=TOL)
    for a, b in zip(leaves(sg), leaves(sc)):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.cuda
def test_cli_on_the_card(cuda_device, tmp_path):
    res, eng = train_cli.main(["--arch", "rwkv6-1.6b", "--reduced",
                               "--steps", "4", "--eval-every", "2",
                               "--ckpt-dir", str(tmp_path)])
    assert eng.device.type == "cuda" and (eng.captures, eng.replays) == (1, 2)
    assert res.steps == [0, 2, 4] and all(np.isfinite(res.upper_loss))
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == \
        "ckpt_00000004.npz"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_vmapped_gradient_is_the_same_every_call(cuda_device, arch):
    """The loss's gradient vmapped over K nodes' batches (with their
    extras), twice on the card: bit for bit the same, which fused and
    per-step runs being equal rests on."""
    cfg = get(arch).reduced()
    params = init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(SEED), device=cuda_device)
    batch = make_lm_step_batch(cfg, torch.Generator(
        device=cuda_device).manual_seed(1), 4, B, S, J=2)["f"]

    def grads():
        return leaves(torch.func.vmap(lambda b: torch.func.grad(
            lambda q: loss_fn(cfg, q, b))(params))(batch))

    first, second = grads(), grads()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(bool(torch.isfinite(a).all()) for a in first)

