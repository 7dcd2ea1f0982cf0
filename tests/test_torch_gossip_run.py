"""Whole runs of the port's compressed and asynchronous gossip against the
JAX package's ``Engine``, and the port's own contracts on them.

Parity (the setting, helpers and limits of ``test_torch_bilevel_run.py``:
losses within TOL_LOSS, consensus within TOL_CONS relative, the final
state within TOL_STATE): MDBO and VRDBO on ``compressed_topk`` at ratio
0.25, plain and EF21, and MDBO on ``async_gossip`` at τ 2 under a ``(K,
2)`` drop pattern of 0s and 1s (every delivery certain, so the packages'
different draws agree), plain and EF21, on the same NodeSampler batches
and the reference's J̃. The reference's async runs are fused with a live
``Recorder`` (its fused run equals its per-step run); the port's drained
metrics must equal its snapshot: the mix bytes and the staleness histogram
exactly, the chunk means within TOL_CONS relative (the same sums of the
same values, up to the rounding the runs already differ by).

Within the port: fused == per_step bit for bit, every mix slot included,
for every new backend (``compressed_rand`` too, and the async runs on the
port's own delivery draws); async τ = 0 == ``ring_rolled`` bit for bit;
a live recorder leaves every number unchanged. The LM trainer passes
``mix_kwargs`` through ``make_trainer_engine`` (a reduced dense config
against the JAX trainer on its own batches and J̃, with the limits of
``test_torch_trainer_run.py``), and the CLI writes ``--metrics`` and
``--trace-dir`` files under the JAX CLI's names.

The reference runs are built once per module. Top-k at these sizes (4 or
8 of 16 or 32 entries a node) has wide gaps between magnitudes, so no
selection flips between the packages.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import repro.configs  # noqa: E402
import repro.core.engine as rengine  # noqa: E402
import repro.data as rlmdata  # noqa: E402
import repro.models  # noqa: E402
import repro.obs as robs  # noqa: E402
import repro.train as rtrain  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.train as ptrain  # noqa: E402
from repro.core import HParams as RHParams  # noqa: E402
from repro.core import HypergradConfig as RCfg  # noqa: E402
from repro.core import logreg_hyperopt as rlogreg  # noqa: E402
from repro.core import ring as rring  # noqa: E402
from repro.data import synthetic as rdata  # noqa: E402
from repro_torch.core import (Engine, HParams, HypergradConfig,  # noqa: E402
                              logreg_hyperopt, ring)
from repro_torch.data import synthetic as pdata  # noqa: E402
from repro_torch.launch import train as ptrain_cli  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_bilevel_run import (D, EVAL, HP, HP_DEFAULT, J, K,  # noqa: E402
                                    SEED, STEPS, TOL_CONS,
                                    assert_run_parity, reference_jtilde,
                                    sampler, x0_y0)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

DROP = np.array([[0, 1], [1, 0], [1, 1], [0, 0]], np.float32)  # (K, 2)
TOPK, TOPK_EF = {"ratio": 0.25}, {"ratio": 0.25, "error_feedback": True}
ASYNC = {"tau": 2, "drop_prob": DROP}
ASYNC_EF = {**ASYNC, "error_feedback": True, "ratio": 0.25}
REFERENCE = {
    "mdbo-topk": ("mdbo", "compressed_topk", TOPK),
    "mdbo-topk-ef": ("mdbo", "compressed_topk", TOPK_EF),
    "vrdbo-topk": ("vrdbo", "compressed_topk", TOPK),
    "vrdbo-topk-ef": ("vrdbo", "compressed_topk", TOPK_EF),
    "mdbo-async": ("mdbo", "async_gossip", ASYNC),
    "mdbo-async-ef": ("mdbo", "async_gossip", ASYNC_EF),
}
# every new backend, on the port's own draws for async gossip
BACKENDS = {
    "topk": ("compressed_topk", TOPK), "topk-ef": ("compressed_topk", TOPK_EF),
    "rand": ("compressed_rand", {"ratio": 0.5, "seed": 3}),
    "rand-ef": ("compressed_rand", {"ratio": 0.25, "error_feedback": True}),
    "async": ("async_gossip", {"tau": 3, "drop_prob": 0.4, "seed": 5}),
    "async-ef": ("async_gossip", {"tau": 2, "drop_prob": 0.3,
                                  "error_feedback": True, "ratio": 0.25}),
}


def reference_run(algo, mix, mix_kwargs):
    """The reference's run: fused with a live Recorder for async gossip,
    per_step otherwise."""
    x0, y0 = x0_y0()
    fused = mix == "async_gossip"
    rec = robs.Recorder() if fused else None
    eng = rengine.Engine(rlogreg(d=D, lip_gy=5.0), RCfg(J=J, lip_gy=5.0),
                         RHParams(*HP.get(algo, HP_DEFAULT)), rring(K),
                         algo=algo, mix=mix, mix_kwargs=mix_kwargs,
                         dispatch="fused" if fused else "per_step",
                         recorder=rec)
    smp = sampler(rdata)
    res, state = eng.run(smp, smp.eval_batch(), steps=STEPS, seed=SEED,
                         eval_every=EVAL, x0=jnp.asarray(x0),
                         y0=jnp.asarray(y0), return_state=True)
    return (res, [np.asarray(t) for t in state]), rec


def port_run(algo, mix, mix_kwargs, dispatch="per_step", steps=STEPS,
             recorder=None, jtilde=None):
    """``(result, state)`` and the engine."""
    x0, y0 = x0_y0()
    eng = Engine(logreg_hyperopt(d=D, lip_gy=5.0),
                 HypergradConfig(J=J, lip_gy=5.0),
                 HParams(*HP.get(algo, HP_DEFAULT)), ring(K), algo=algo,
                 mix=mix, mix_kwargs=mix_kwargs, dispatch=dispatch,
                 recorder=recorder, device="cpu")
    smp = sampler(pdata)
    if jtilde is None:
        jtilde = reference_jtilde(SEED, K, J, steps)
    out = eng.run(smp, smp.eval_batch(), steps=steps, seed=SEED,
                  eval_every=EVAL, x0=x0, y0=y0, return_state=True,
                  jtilde=jtilde)
    return out, eng


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's runs, built once."""
    return {name: reference_run(*run) for name, run in REFERENCE.items()}


@pytest.mark.parametrize("name", list(REFERENCE))
def test_whole_run_parity(reference_runs, name):
    (ref, _), (algo, mix, mk) = reference_runs[name], REFERENCE[name]
    (port, eng) = port_run(algo, mix, mk)
    assert_run_parity(ref, port)
    assert len(eng.mix_states) == (4 if mk is not TOPK else 0)


def assert_bitwise(a, b):
    (ra, sa), (rb, sb) = a, b
    for name in ("steps", "upper_loss", "lower_loss", "consensus_x",
                 "consensus_y"):
        assert getattr(ra, name) == getattr(rb, name)
    la, lb = pytree.tree_leaves(sa), pytree.tree_leaves(sb)
    assert len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_fused_equals_per_step_bitwise_mix_state_included(algo, backend):
    """13 steps: chunks of 5, 5 and 3; every per-site slot (EF
    accumulators; async caches and ages) is equal at the end too."""
    mix, mk = BACKENDS[backend]
    (per_step, pe), (fused, fe) = (port_run(algo, mix, mk, d, steps=13)
                                   for d in ("per_step", "fused"))
    assert_bitwise(per_step, fused)
    stateful = mk.get("error_feedback") or mix == "async_gossip"
    assert len(pe.mix_states) == (4 if stateful else 0)
    assert_bitwise((per_step[0], pe.mix_states), (fused[0], fe.mix_states))
    assert np.all(np.isfinite(fused[0].upper_loss))


@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
def test_async_tau0_equals_ring_rolled_bitwise(algo):
    """τ = 0 forces every delivery even at drop 0.7: synchronous ring
    gossip, bit for bit, per step and fused."""
    for dispatch in ("per_step", "fused"):
        ring_run, _ = port_run(algo, "ring_rolled", None, dispatch, steps=13)
        async_run, eng = port_run(algo, "async_gossip",
                                  {"tau": 0, "drop_prob": 0.7}, dispatch,
                                  steps=13)
        assert_bitwise(ring_run, async_run)
        assert all(int(s[k].max()) == 0 for s in eng.mix_states
                   for k in ("age_left", "age_right"))


@pytest.mark.parametrize("name", ["mdbo-async", "mdbo-async-ef"])
def test_drained_metrics_equal_the_reference_recorder(reference_runs, name):
    """A live recorder leaves every number of the run bit for bit as it
    was; its drained counters and histogram equal the JAX recorder's, its
    chunk means are within TOL_CONS relative (or 1e-12)."""
    (_, rrec), (algo, mix, mk) = reference_runs[name], REFERENCE[name]
    rec = Recorder()
    (with_obs, _), (without, _) = (port_run(algo, mix, mk, "fused",
                                            recorder=r) for r in (rec, None))
    assert_bitwise(with_obs, without)
    got, want = rec.snapshot(), rrec.snapshot()
    assert got["counters"] == want["counters"]
    assert got["counters"]["train_mix_bytes"] > 0
    assert got["hist_counts"] == want["hist_counts"]
    assert sum(got["hist_counts"]["train_staleness"]) == STEPS * 4 * 2 * K
    assert got["gauges"].keys() == want["gauges"].keys()
    for k, v in want["gauges"].items():
        assert got["gauges"][k] == pytest.approx(v, rel=TOL_CONS, abs=1e-12)
    kinds = [e["kind"] for e in rec.events]
    assert kinds == [e["kind"] for e in rrec.events]
    assert kinds.count("drain") == STEPS // EVAL


def test_mix_sites_run_no_arithmetic():
    """The call sites of a step, found on ``meta`` tensors: MDBO mixes zf,
    zg, x and y; GDSBO x and y."""
    from repro_torch.core.hypergrad import draw_jtilde

    for algo, n in (("mdbo", 4), ("gdsbo", 2)):
        (_, state), eng = port_run(algo, "compressed_topk", TOPK_EF,
                                   steps=0)
        smp = sampler(pdata)
        batch = eng._to_device(smp.sample())
        sites = eng._mix_sites(state, batch, draw_jtilde(
            eng.cfg, (K,), torch.Generator()))
        assert len(sites) == n
        assert all(t.device.type == "meta" for t in sites)
        assert [tuple(t.shape) for t in sites[-2:]] == [(K, D), (K, D, 2)]


# ---------------------------------------------------------------------------
# the LM trainer and its CLI
# ---------------------------------------------------------------------------

TK, TB, TS, TJ, TSTEPS = 3, 2, 8, 2, 4
TR_HP = dict(eta=0.1, beta1=0.05, beta2=0.5)
NARROW = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
              vocab=64)


def test_trainer_engine_passes_mix_kwargs(tmp_path):
    """``make_trainer_engine(mix='async_gossip', mix_kwargs=...)`` on a
    tiny dense config at K = 3 against the JAX trainer, 4 steps per step,
    on the reference's own batches (recomputed from its ``key_schedule``)
    and J̃; losses within 1e-5, consensus within 1e-4 relative, every
    state leaf within 1e-4 of its largest entry (the limits of
    ``test_torch_trainer_run.py``)."""
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(**NARROW)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **NARROW)
    mk = {"tau": 2, "drop_prob": np.array([[1, 0], [0, 0], [0, 1]],
                                          np.float32)}
    key = jax.random.PRNGKey(SEED)
    _, _, key = jax.random.split(key, 3)
    key, k0 = jax.random.split(key)
    kb0, _ = jax.random.split(k0)
    kbs, _ = rengine.key_schedule(key, TSTEPS)
    batches = [jax.tree.map(np.asarray, rlmdata.make_lm_step_batch(
        jcfg, k, TK, TB, TS, J=TJ)) for k in [kb0] + list(kbs)]
    x0 = np.full((rtrain.x_dim(jcfg),), -4.0, np.float32)
    y0 = jax.tree.map(np.asarray, repro.models.init_params(
        jcfg, jax.random.PRNGKey(1)))
    ev = jax.tree.map(np.asarray, rlmdata.make_node_batch(
        jcfg, jax.random.PRNGKey(SEED + 17), TB, TS))

    rtc = rtrain.TrainerConfig(algo="mdbo", J=TJ, hp=RHParams(**TR_HP))
    _, reng = rtrain.make_trainer_engine(jcfg, rtc, TK, dispatch="per_step",
                                         mix="async_gossip", mix_kwargs=mk)
    rres, rstate = reng.run(rlmdata.make_device_lm_sampler(jcfg, rtc, TK, TB,
                                                           TS),
                            ev, steps=TSTEPS, seed=SEED, eval_every=2,
                            x0=jnp.asarray(x0),
                            y0=jax.tree.map(jnp.asarray, y0),
                            return_state=True)
    ptc = ptrain.TrainerConfig(algo="mdbo", J=TJ, hp=HParams(**TR_HP))
    _, peng = ptrain.make_trainer_engine(tcfg, ptc, TK, dispatch="per_step",
                                         mix="async_gossip", mix_kwargs=mk,
                                         device="cpu")
    it = iter(batches)
    pres, pstate = peng.run(
        lambda g: jax.tree.map(torch.from_numpy, next(it)),
        jax.tree.map(torch.from_numpy, ev), steps=TSTEPS, seed=SEED,
        eval_every=2, x0=torch.from_numpy(x0),
        y0=params_from_jax(y0, device="cpu"), return_state=True,
        jtilde=reference_jtilde(SEED, TK, TJ, TSTEPS))
    assert pres.steps == rres.steps == [0, 2, 4]
    for name in ("upper_loss", "lower_loss"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=0, atol=1e-5)
    for name in ("consensus_x", "consensus_y"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=1e-4, atol=1e-12)
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tuple(rstate))[0]}
    got = {pytree.keystr(k): v.numpy() for k, v in
           pytree.tree_flatten_with_path(tuple(pstate))[0]}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4 * max(
            float(np.abs(v).max()), 1e-30), err_msg=k)
    assert len(peng.mix_states) == 4


def test_cli_writes_metrics_and_trace(tmp_path, capsys):
    """``--metrics DIR`` and ``--trace-dir DIR``: the JAX CLI's file names,
    the drained trainer metrics in the JSONL log and the Prometheus text,
    the chunk and eval spans in the Chrome trace."""
    mdir, tdir = tmp_path / "m", tmp_path / "t"
    ptrain_cli.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                     "--nodes", "2", "--batch", "1", "--seq", "8",
                     "--steps", "3", "--eval-every", "2",
                     "--metrics", str(mdir), "--trace-dir", str(tdir)])
    out = capsys.readouterr().out.splitlines()
    rrec, rfinal = robs.cli_recorder(str(tmp_path / "rm"),
                                     str(tmp_path / "rt"))
    rrec.event("x")
    want = [p.replace(str(tmp_path / "rm"), str(mdir)).replace(
        str(tmp_path / "rt"), str(tdir)) for p in rfinal()]
    assert [line for line in out if line.startswith("obs: ")] == [
        f"obs: {p}" for p in want]
    events = [json.loads(line) for line in
              (mdir / "metrics.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == [
        "metrics", "drain", "metrics", "drain", "metrics", "run_done"]
    assert events[1]["train_mix_bytes"] > 0 and events[1]["step"] == 2
    prom = (mdir / "metrics.prom").read_text()
    assert "# TYPE train_mix_bytes counter" in prom
    assert "train_steps 3" in prom
    names = [e["name"] for e in json.loads(
        (tdir / "trace.json").read_text())["traceEvents"]]
    assert names.count("train_chunk") == 2 and names.count("eval") == 3
