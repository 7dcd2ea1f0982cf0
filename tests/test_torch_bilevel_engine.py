"""The port's ``Engine`` beyond the dense per-step run: whole-run parity
with the JAX package's on the ``ring_rolled`` mix (the same setting and
tolerances as ``test_torch_bilevel_run.py``, whose helpers it uses),
fused dispatch bit for bit equal to per-step dispatch on the CPU, the
engine's own randomness, ``driver.run``, the not-yet-ported backends, the
default device, and the AST lint on the new modules.

On the CPU, fused dispatch is the plain loop; on CUDA each chunk is one
CUDA graph replay (``tests/test_torch_bilevel_cuda.py`` and phase 12 of
``chip_smoke.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

import repro_torch.core.driver as pdriver  # noqa: E402
from repro_torch.core import engine as pengine  # noqa: E402
from repro_torch.data import synthetic as pdata  # noqa: E402
from test_torch_bilevel_run import (ALGOS, EVAL, J, K, SEED,  # noqa: E402
                                    STEPS, assert_run_parity, port_engine,
                                    port_run, reference_run, sampler,
                                    x0_y0)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's per-step runs on the ring_rolled mix, built once."""
    return {algo: reference_run(algo, "ring_rolled") for algo in ALGOS}


@pytest.mark.parametrize("algo", ALGOS)
def test_whole_run_parity_ring_rolled(reference_runs, algo):
    assert_run_parity(reference_runs[algo], port_run(algo, "ring_rolled"))


def assert_bitwise(a, b):
    (ra, sa), (rb, sb) = a, b
    for name in ("steps", "upper_loss", "lower_loss", "consensus_x",
                 "consensus_y"):
        assert getattr(ra, name) == getattr(rb, name)
    assert all(torch.equal(u, v) for u, v in zip(sa, sb))


@pytest.mark.parametrize("mix", ["dense", "ring_rolled"])
@pytest.mark.parametrize("algo", ALGOS)
def test_fused_equals_per_step_bitwise_on_cpu(algo, mix):
    """13 steps: two full chunks of 5 and a tail chunk of 3. The fused run
    also records each chunk's mean consensus, as the reference's does."""
    per_step = port_run(algo, mix, "per_step", steps=13)
    fused = port_run(algo, mix, "fused", steps=13)
    assert_bitwise(per_step, fused)
    assert per_step[0].steps == [0, 5, 10, 13]
    assert per_step[0].extra == {}
    assert set(fused[0].extra) == {"scan_cx_mean", "scan_cy_mean"}
    assert len(fused[0].extra["scan_cy_mean"]) == 4


def test_fused_equals_per_step_with_the_engines_own_randomness():
    """No J̃ schedule and no x0/y0: the engine draws J̃ and the initial
    parameters from generators seeded from ``seed``, and a device sampler
    draws from the engine's batch generator, so two dispatches agree bit
    for bit; another seed gives another run."""
    ds = pdata.make_classification(n=600, d=16, c=2, seed=SEED)
    tr, va = pdata.train_val_split(ds, 0.3, seed=SEED)
    smp = pdata.make_device_sampler(pdata.shard_to_nodes(tr, K),
                                    pdata.shard_to_nodes(va, K), batch=8,
                                    J=J, device="cpu")
    ev = sampler(pdata).eval_batch()
    runs = {}
    for dispatch, seed in (("per_step", 0), ("fused", 0), ("fused", 1)):
        eng = port_engine("vrdbo", "dense", dispatch)
        runs[(dispatch, seed)] = eng.run(smp, ev, steps=10, seed=seed,
                                         eval_every=EVAL, return_state=True)
    assert_bitwise(runs[("per_step", 0)], runs[("fused", 0)])
    assert runs[("fused", 1)][0].upper_loss != runs[("fused", 0)][0].upper_loss
    res, state = runs[("fused", 0)]
    assert res.upper_loss[-1] < res.upper_loss[0]
    assert state.y.shape == (K, 16, 2)


def test_engine_draws_jtilde_in_range_and_validates_a_schedule():
    eng = port_engine("mdbo", "dense")
    seen = []
    orig = eng.step

    def spy(state, batch, jtilde):
        seen.append(jtilde.clone())
        return orig(state, batch, jtilde)

    eng.step = spy
    smp = sampler(pdata)
    eng.run(smp, smp.eval_batch(), steps=30, eval_every=10)
    jt = torch.stack(seen)
    assert jt.shape == (30, K) and jt.dtype == torch.int64
    assert set(jt.unique().tolist()) == set(range(J))
    with pytest.raises(ValueError, match=r"\[steps \+ 1, K\]"):
        eng.run(smp, smp.eval_batch(), steps=3, jtilde=np.zeros((3, K)))
    with pytest.raises(ValueError, match="lie in"):
        eng.run(smp, smp.eval_batch(), steps=3,
                jtilde=np.full((4, K), J, np.int64))


def test_run_hooks_results_and_driver():
    """on_eval fires at every eval (t = 0 included), extra_metrics are
    recorded, rows carry them, and ``driver.run`` is ``Engine.run``."""
    from repro_torch.core import accuracy

    x0, y0 = x0_y0()
    jt = np.random.default_rng(0).integers(0, J, (STEPS + 1, K))
    smp = sampler(pdata)
    ev = smp.eval_batch()
    hits = []
    res, state = port_run(
        "gdsbo", "ring_rolled", "fused", jtilde=jt,
        on_eval=lambda t, s: hits.append((t, float(s.x.abs().sum()))),
        extra_metrics=lambda s, b: {"acc": accuracy(s.y.mean(0), b)})
    assert [t for t, _ in hits] == [0, 5, 10, 15, 20]
    assert len(res.extra["acc"]) == 5 and 0.0 <= res.extra["acc"][-1] <= 1.0
    rows = list(res.as_rows())
    assert rows[-1]["step"] == 20 and rows[-1]["acc"] == res.extra["acc"][-1]
    assert rows[0]["algo"] == "gdsbo"
    eng = port_engine("gdsbo", "ring_rolled")
    r2 = pdriver.run(eng.problem, eng.cfg, eng.hp, pengine.ring(K), "gdsbo",
                     sampler(pdata), ev, steps=STEPS, seed=3,
                     eval_every=EVAL, x0=x0, y0=y0, dispatch="per_step",
                     mix_backend="ring_rolled", device="cpu")
    r3 = eng.run(sampler(pdata), ev, steps=STEPS, seed=3, eval_every=EVAL,
                 x0=x0, y0=y0)
    assert r2.upper_loss == r3.upper_loss
    assert pdriver.ALGOS == ("mdbo", "vrdbo", "dsbo", "gdsbo")


def test_graph_state_copy_reads_aliased_sources_first():
    """The captured chunk ends by copying its last state into its input
    state; after one VRDBO step the new ``x_prev`` is the input's ``x``
    itself, which the copy must read before it overwrites ``x``."""
    x, x_prev = torch.tensor([1.0]), torch.tensor([0.0])
    state = (x, x_prev)
    out = (torch.tensor([2.0]), x)
    pengine._copy_into(state, out)
    assert (float(x), float(x_prev)) == (2.0, 1.0)
    pengine._copy_into(state, state)       # a state onto itself: no-op
    assert (float(x), float(x_prev)) == (2.0, 1.0)


def test_default_init_is_seeded():
    """x0/y0 come from the problem's init on a host generator seeded from
    ``seed`` (so a CPU and a CUDA run start alike)."""
    eng = port_engine("dsbo", "dense")
    smp = sampler(pdata)
    a = eng.run(smp, smp.eval_batch(), steps=0, seed=4, return_state=True)
    smp = sampler(pdata)
    b = eng.run(smp, smp.eval_batch(), steps=0, seed=4, return_state=True)
    assert torch.equal(a[1].y, b[1].y)
    assert float(a[1].y.abs().sum()) > 0 and float(a[1].x.abs().sum()) == 0


def test_registries_and_not_ported_backends():
    assert set(pengine.ALGORITHMS) == {"mdbo", "vrdbo", "dsbo", "gdsbo",
                                       "gt_sgd"}
    assert set(pengine.MIX_BACKENDS) == {"dense", "ring_rolled",
                                         "compressed_topk", "compressed_rand",
                                         "async_gossip"}
    assert pengine.NOT_PORTED_MIXES == ("ring_local",)
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        pengine.make_mix("ring_local", K=4)
    with pytest.raises(NotImplementedError):
        port_engine("mdbo", "ring_local")
    with pytest.raises(ValueError, match="unknown mix"):
        pengine.make_mix("nope", K=4)
    with pytest.raises(ValueError, match="dense mix needs"):
        pengine.make_mix("dense")
    with pytest.raises(ValueError, match="unknown algo"):
        port_engine("sgd", "dense")
    with pytest.raises(ValueError, match="dispatch"):
        port_engine("mdbo", "dense", dispatch="scan")
    assert not sampler(pdata).device_resident
    assert pengine.DeviceSampler(lambda g: g).device_resident


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.core import problems

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = port_engine("mdbo", "dense")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pengine.Engine(eng.problem, eng.cfg, eng.hp, K)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdriver.run(eng.problem, eng.cfg, eng.hp, K, "mdbo",
                    sampler(pdata), None, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        problems.quadratic_problem()
    s = sampler(pdata)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdata.make_device_sampler(s.tr, s.va, batch=2, J=1)


def test_new_modules_pass_the_reference_ast_lint():
    """The port's core and data modules lint clean under the JAX package's
    own AST rules, with no suppression."""
    from repro.analysis.ast_rules import lint_source

    files = sorted((ROOT / "src" / "repro_torch" / "core").glob("*.py")) + \
        sorted((ROOT / "src" / "repro_torch" / "data").glob("*.py"))
    assert len(files) == 17
    for f in files:
        text = f.read_text()
        assert "noqa" not in text
        assert lint_source(text, str(f.relative_to(ROOT))) == []
