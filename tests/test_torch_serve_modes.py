"""The rest of the JAX ``ServeEngine`` in the port, held to the JAX engine
on the CPU: the cohort drain, the ``kv_impl`` read paths, pow2 prefill
buckets, ``SpecConfig.rounds``, and the request and drain metrics a live
``Recorder`` gets.

Both packages serve the same weights (the JAX package's
``init_params``, carried over with ``params_from_jax``) at the narrow
widths of ``tests/test_serve_obs.py`` (the head dim raised to 32, the
smallest the flash kernel's wrapper takes): reduced ``smollm-360m`` and
reduced ``qwen2.5-3b`` with nonzero QKV biases. Streams and host-side
counters compare exactly; timings do not, so ``prefill_s`` and the
latency values are left out. The obs cases run on
``tests/test_serve_obs.py``'s pool-starved workload, where preemptions,
admission rejects and restarts all show.
"""
import inspect
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro.obs  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.models  # noqa: E402
import repro_torch.obs  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro_torch.weights import params_from_jax, truncate_params  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

NARROW = {"smollm-360m": dict(d_model=32, n_heads=2, n_kv_heads=2,
                              head_dim=32, d_ff=64, vocab=64),
          "qwen2.5-3b": dict(d_model=32, n_heads=4, n_kv_heads=2,
                             head_dim=32, d_ff=64, vocab=64)}
PROMPT_BUDGETS = [9, 8, 10, 7, 9]
# tests/test_serve_obs.py's pool-starved paged engine
STARVED = dict(capacity=32, max_batch=4, decode_chunk=4, mode="paged",
               block_size=4, num_blocks=7)
# a prompt whose greedy stream on the narrow smollm starts with two
# different tokens (the reference's [5, 9, 2, 7] repeats its first token
# here, which would make the second-token EOS case the first-token one)
EOS_PROMPT = [2, 7, 1, 8]
# bucketed against exact-length prefill: tests/test_scheduler.py's limit
TOL_BUCKET = 2e-4
# f32 logits of the two packages on the same weights (matmul sums in other
# orders, ~1e-7 relative at these sizes)
TOL = 1e-5


def build(arch, *, key=0, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) at the narrow widths;
    a QKV bias gets nonzero values from a seeded numpy draw."""
    kw = {**NARROW[arch], **overrides}
    jcfg = repro.configs.get(arch).reduced().with_overrides(**kw)
    tcfg = repro_torch.configs.get(arch).reduced().with_overrides(**kw)
    jp = jax.tree.map(np.asarray,
                      repro.models.init_params(jcfg, jax.random.PRNGKey(key)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(3)
        for name in ("wq", "wk", "wv"):
            leaf = jp["layers"]["attn"][name]
            leaf["b"] = (0.5 * rng.standard_normal(leaf["b"].shape)
                         ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jax.numpy.asarray, jp),
            params_from_jax(jp, device="cpu"))


@pytest.fixture(scope="module")
def smollm():
    return build("smollm-360m")


@pytest.fixture(scope="module")
def qwen():
    return build("qwen2.5-3b")


def workload(vocab, seed=1, budgets=PROMPT_BUDGETS):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=rng.integers(4, 12))
               for _ in budgets]
    return list(zip(prompts, budgets))


def drain(eng, reqs):
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    return rids, [res[r] for r in rids]


def host_stats(stats):
    return {k: v for k, v in stats.items() if k != "prefill_s"}


def both(model, reqs, **kw):
    """Drain ``reqs`` through the JAX engine and the port's with the same
    keywords; streams and stats must be equal. Returns both engines."""
    jcfg, tcfg, jp, tp = model
    jeng = repro.serve.ServeEngine(jcfg, jp, **kw)
    teng = repro_torch.serve.ServeEngine(tcfg, tp, device="cpu", **kw)
    _, jout = drain(jeng, reqs)
    _, tout = drain(teng, reqs)
    assert tout == jout
    assert host_stats(teng.stats) == host_stats(jeng.stats)
    return jeng, teng


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------

def test_engine_signature_accepts_every_jax_keyword():
    jsig = inspect.signature(repro.serve.ServeEngine.__init__).parameters
    tsig = inspect.signature(repro_torch.serve.ServeEngine.__init__
                             ).parameters
    assert list(jsig) == [p for p in tsig if p != "device"]
    for name, p in jsig.items():
        assert tsig[name].default == p.default, name
        assert tsig[name].kind == p.kind, name
    assert tsig["device"].default == "cuda"


def test_kv_impl_choices_and_resolution(smollm):
    jcfg, tcfg, jp, tp = smollm
    assert repro_torch.serve.engine.KV_IMPLS == repro.serve.engine.KV_IMPLS
    for kv_impl, path in (("auto", "kernel"), ("kernel", "kernel"),
                          ("pallas", "pallas"), ("reference", "reference")):
        eng = repro_torch.serve.ServeEngine(tcfg, tp, mode="paged",
                                            capacity=16, max_batch=2,
                                            kv_impl=kv_impl, device="cpu")
        assert eng.kv_impl == path
    with pytest.raises(ValueError, match="kv_impl must be") as jerr:
        repro.serve.ServeEngine(jcfg, jp, mode="paged", kv_impl="nope")
    with pytest.raises(ValueError, match="kv_impl must be") as terr:
        repro_torch.serve.ServeEngine(tcfg, tp, mode="paged", kv_impl="nope",
                                      device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the cohort drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b"])
def test_cohort_streams_and_stats_match_jax(arch, smollm, qwen):
    """Five requests in cohorts of 2, 2 and 1: left-padded prompts of 4-11
    tokens, budgets 7-10, so a cohort decodes past a request that already
    finished."""
    model = smollm if arch == "smollm-360m" else qwen
    jeng, teng = both(model, workload(model[0].vocab), mode="cohort",
                      capacity=32, max_batch=2)
    assert teng.stats["prefills"] == 3
    assert teng.stats["peak_concurrency"] == 2
    assert teng.scheduler.n_admitted == teng.scheduler.n_finished == 5
    # first-token and finish times are the cohort's
    reqs = [teng.completed[r] for r in sorted(teng.completed)]
    assert reqs[0].first_token_s == reqs[1].first_token_s
    assert reqs[0].finish_s == reqs[1].finish_s < reqs[2].first_token_s


def test_cohort_pads_are_attended_as_in_jax(smollm):
    """The legacy drain attends its left pads: a short prompt batched with
    a longer one gets another stream than alone, the same one as the JAX
    drain."""
    long_p = np.arange(1, 12) % 64
    short = [(np.asarray([2, 7, 1, 8]), 5), (long_p, 5)]
    _, teng = both(smollm, short, mode="cohort", capacity=32, max_batch=2)
    _, alone = both(smollm, short[:1], mode="cohort", capacity=32,
                    max_batch=2)
    assert teng.completed[0].output != alone.completed[0].output


def counting_engine(tcfg, tp, eos_id):
    eng = repro_torch.serve.ServeEngine(tcfg, tp, capacity=32, max_batch=2,
                                        eos_id=eos_id, mode="cohort",
                                        decode_chunk=4, device="cpu")
    calls = [0]
    orig = eng._decode

    def counted(*args):
        calls[0] += 1
        return orig(*args)

    eng._decode = counted
    return eng, calls


def test_cohort_eos_contracts(smollm):
    """No decode step after a prefill EOS, and exactly one when the second
    token is EOS; the streams are the JAX cohort drain's."""
    jcfg, tcfg, jp, tp = smollm
    eng = repro_torch.serve.ServeEngine(tcfg, tp, capacity=32, max_batch=2,
                                        device="cpu")
    t0, t1 = drain(eng, [(EOS_PROMPT, 2)])[1][0]
    assert t0 != t1
    for eos, want, n_calls in ((t0, [t0], 0), (t1, [t0, t1], 1)):
        teng, calls = counting_engine(tcfg, tp, eos)
        assert drain(teng, [(EOS_PROMPT, 8)])[1] == [want]
        assert calls[0] == n_calls
        jeng = repro.serve.ServeEngine(jcfg, jp, capacity=32, max_batch=2,
                                       eos_id=eos, mode="cohort")
        assert drain(jeng, [(EOS_PROMPT, 8)])[1] == [want]


def test_cohort_refuses_stream(smollm):
    jcfg, tcfg, jp, tp = smollm
    errs = []
    for eng in (repro.serve.ServeEngine(jcfg, jp, mode="cohort"),
                repro_torch.serve.ServeEngine(tcfg, tp, mode="cohort",
                                              device="cpu")):
        with pytest.raises(ValueError, match="stream") as err:
            next(eng.stream())
        errs.append(str(err.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# the paged read paths
# ---------------------------------------------------------------------------

def test_kv_impl_reference_matches_jax_under_preemption(smollm):
    """The gather/scatter read path on the pool-starved workload against
    the JAX engine's reference path: streams and every host counter."""
    _, teng = both(smollm, workload(64), kv_impl="reference", **STARVED)
    assert teng.stats["preemptions"] > 0
    kernel = repro_torch.serve.ServeEngine(smollm[1], smollm[3],
                                           device="cpu", **STARVED)
    _, streams = drain(kernel, workload(64))
    assert streams == [teng.completed[r].output
                       for r in sorted(teng.completed)]


def test_kv_impl_pallas_is_the_kernel_path(qwen):
    _, tcfg, _, tp = qwen
    out = []
    for kv_impl in ("kernel", "pallas"):
        eng = repro_torch.serve.ServeEngine(tcfg, tp, kv_impl=kv_impl,
                                            device="cpu", **STARVED)
        out.append((drain(eng, workload(64))[1], host_stats(eng.stats)))
    assert out[0] == out[1]


def test_reference_step_reads_the_pool_before_its_writes(qwen):
    """One ``make_paged_decode`` chunk against the JAX package's on the
    same pool, tables (two slots sharing a page, a dead slot) and state:
    tokens, emit masks and the pool after it."""
    from repro.serve.steps import make_paged_decode as jax_make
    from repro_torch.serve.steps import make_paged_decode

    jcfg, tcfg, jp, tp = qwen
    bs, L = 4, jcfg.n_layers
    rng = np.random.default_rng(4)
    shape = (9, bs, L, jcfg.n_kv_heads, jcfg.head_dim)
    pool = {"kv": {n: rng.standard_normal(shape).astype(np.float32)
                   for n in ("k", "v")}}
    tables = np.asarray([[0, 1, 2, 8], [0, 3, 4, 8], [5, 8, 8, 8]], np.int32)
    tok = np.asarray([5, 9, 3], np.int32)
    idx = np.asarray([9, 6, 2], np.int32)
    live = np.asarray([True, True, False])
    remaining = np.asarray([3, 1, 0], np.int32)
    batch_axes = repro.models.cache_batch_axes(jcfg, 16)
    cap_axes = repro.models.cache_capacity_axes(jcfg, 16)
    jfn = jax.jit(jax_make(jcfg, {"kv": batch_axes["kv"]},
                           {"kv": cap_axes["kv"]}, bs, 3, None))
    jout = jfn(jp, tok, pool, tables, idx, live, remaining)
    tpool = {"kv": {n: torch.from_numpy(a.copy())
                    for n, a in pool["kv"].items()}}
    t = {name: torch.from_numpy(a) for name, a in (
        ("tok", tok), ("tables", tables), ("idx", idx), ("live", live),
        ("remaining", remaining))}
    tout = make_paged_decode(tcfg, bs, 3, None)(
        tp, t["tok"], tpool, t["tables"], t["idx"], t["live"],
        t["remaining"])
    for j, t in zip(jout, tout):
        if isinstance(t, dict):
            for n in ("k", "v"):
                assert np.abs(t["kv"][n].numpy()
                              - np.asarray(j["kv"][n])).max() < TOL
        else:
            assert np.array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# pow2 prefill buckets
# ---------------------------------------------------------------------------

def test_bucketed_prefill_logits_within_limit(qwen):
    """Right-padded prefill against exact length in the port (the JAX
    test's limit), and against the JAX package's padded prefill."""
    jcfg, tcfg, jp, tp = qwen
    rng = np.random.default_rng(1)
    for L in (3, 7, 13, 21):
        p = rng.integers(0, tcfg.vocab, size=L).astype(np.int32)
        pad = np.zeros(32, np.int32)
        pad[:L] = p
        lg_e, c_e = repro_torch.models.prefill(tcfg, tp,
                                               torch.from_numpy(p[None]), 32)
        lg_b, c_b = repro_torch.models.prefill(
            tcfg, tp, torch.from_numpy(pad[None]), 32, length=L)
        assert float((lg_e - lg_b).abs().max()) <= TOL_BUCKET
        assert c_b["idx"] == L
        assert float((c_e["kv"]["k"][:, :, :L]
                      - c_b["kv"]["k"][:, :, :L]).abs().max()) <= TOL_BUCKET
        lg_j, _ = repro.models.prefill(jcfg, jp, jax.numpy.asarray(pad[None]),
                                       32, length=jax.numpy.asarray(L))
        assert np.abs(lg_b.numpy() - np.asarray(lg_j)).max() < TOL


@pytest.mark.parametrize("mode", ["continuous", "paged"])
def test_bucketed_engine_streams_match_jax(mode, qwen):
    jeng, teng = both(qwen, workload(64, seed=2, budgets=[5, 4, 6, 5]),
                      mode=mode, capacity=32, max_batch=2, decode_chunk=3,
                      prefill_bucket=True)
    assert teng._bucket and jeng._bucket
    batch = teng._admission_batch(repro_torch.serve.Request(
        0, np.arange(5, dtype=np.int32)))
    assert tuple(batch["tokens"].shape) == (1, 8) and batch["length"] == 5


def test_bucketing_refused_for_hybrid_ssm_and_windowed():
    for arch, kw in (("recurrentgemma-2b", {}), ("rwkv6-1.6b", {}),
                     ("qwen2.5-3b", {"window": 8})):
        jcfg = repro.configs.get(arch).reduced().with_overrides(**kw)
        tcfg = repro_torch.configs.get(arch).reduced().with_overrides(**kw)
        tp = repro_torch.models.init_params(
            tcfg, torch.Generator().manual_seed(0), device="cpu")
        teng = repro_torch.serve.ServeEngine(tcfg, tp, capacity=16,
                                             max_batch=1, prefill_bucket=True,
                                             device="cpu")
        jeng = repro.serve.ServeEngine(
            jcfg, repro.models.init_params(jcfg, jax.random.PRNGKey(0)),
            capacity=16, max_batch=1, prefill_bucket=True)
        assert not teng._bucket and not jeng._bucket, arch
        batch = teng._admission_batch(repro_torch.serve.Request(
            0, np.arange(5, dtype=np.int32)))
        assert tuple(batch["tokens"].shape) == (1, 5) and "length" not in batch


# ---------------------------------------------------------------------------
# speculative rounds
# ---------------------------------------------------------------------------

def test_rounds_for_matches_jax(smollm):
    jcfg, tcfg, jp, tp = smollm
    for k in (1, 2, 3, 4):
        for rounds in (None, 0, 1, 2, 5):
            js = repro.serve.SpecConfig(jcfg, jp, k=k, rounds=rounds)
            ts = repro_torch.serve.SpecConfig(tcfg, tp, k=k, rounds=rounds)
            for chunk in (1, 4, 8, 9):
                assert ts.rounds_for(chunk) == js.rounds_for(chunk)


@pytest.fixture(scope="module")
def damped():
    """A 4-layer narrow smollm whose layers past the first are damped, and
    its first layer as the draft (acceptance neither 0 nor 1)."""
    jcfg, tcfg, jp, tp = build("smollm-360m", key=1, n_layers=4)
    scale = np.asarray([1.0, 0.3, 0.3, 0.3], np.float32)
    jp = {**jp, "layers": jax.tree.map(
        lambda x: x * scale.reshape((-1,) + (1,) * (x.ndim - 1)),
        jp["layers"])}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jdraft = {"embed": jp["embed"], "final_norm": jp["final_norm"],
              "layers": jax.tree.map(lambda x: x[:1], jp["layers"])}
    return (jcfg, tcfg, jp, tp, jcfg.with_overrides(n_layers=1),
            tcfg.with_overrides(n_layers=1), jdraft, truncate_params(tp, 1))


@pytest.mark.parametrize("rounds,kv_impl", [(1, "kernel"), (2, "reference")])
def test_spec_rounds_streams_match_jax(rounds, kv_impl, damped):
    """``SpecConfig(rounds=)`` against the JAX engine, with the verify on
    the kernel's path and on the plain version; the streams equal the
    port's non-speculative drain."""
    jcfg, tcfg, jp, tp, jdc, tdc, jdraft, tdraft = damped
    kw = dict(mode="paged", capacity=48, max_batch=3, decode_chunk=4,
              block_size=8, kv_impl=kv_impl, prefill_bucket=True)
    reqs = workload(64, seed=5, budgets=[9, 7, 12, 5])
    jeng = repro.serve.ServeEngine(
        jcfg, jp, speculate=repro.serve.SpecConfig(jdc, jdraft, k=2,
                                                   rounds=rounds), **kw)
    teng = repro_torch.serve.ServeEngine(
        tcfg, tp, speculate=repro_torch.serve.SpecConfig(
            tdc, tdraft, k=2, rounds=rounds), device="cpu", **kw)
    base = repro_torch.serve.ServeEngine(tcfg, tp, device="cpu", **kw)
    outs = [drain(e, reqs)[1] for e in (jeng, teng, base)]
    assert outs[1] == outs[0] == outs[2]
    assert host_stats({k: teng.stats[k] for k in jeng.stats}) == \
        host_stats(jeng.stats)
    st = teng.stats
    assert st["decode_steps"] == st["decode_dispatches"] * rounds * 3
    assert 0 < st["spec_accepted"] < st["spec_proposed"]


def test_spec_window_of_any_size_serves_as_the_reference(qwen):
    """A qwen-shaped target (G 8 query heads per KV head) speculating k = 8
    verifies a window of Q 9, Q * G 72 rows: the verify kernel takes any
    window, so the engine accepts every SpecConfig the JAX engine does, and
    its streams on the kernel's path equal those of ``kv_impl="reference"``
    and of the JAX engine."""
    jcfg, tcfg, jp, tp = build("qwen2.5-3b", n_heads=16, n_kv_heads=2)
    assert tcfg.n_heads // tcfg.n_kv_heads == 8
    k = 8
    reqs = workload(tcfg.vocab)[:3]
    kw = dict(mode="paged", capacity=48, max_batch=2, decode_chunk=4,
              block_size=4)
    jd = {"embed": jp["embed"], "final_norm": jp["final_norm"],
          "layers": jax.tree.map(lambda t: t[:1], jp["layers"])}
    jeng = repro.serve.ServeEngine(
        jcfg, jp, speculate=repro.serve.SpecConfig(
            jcfg.with_overrides(n_layers=1), jd, k=k), **kw)
    _, jout = drain(jeng, reqs)
    streams = {}
    for kv_impl in ("kernel", "reference"):
        teng = repro_torch.serve.ServeEngine(
            tcfg, tp, device="cpu", kv_impl=kv_impl,
            speculate=repro_torch.serve.SpecConfig(
                tcfg.with_overrides(n_layers=1), truncate_params(tp, 1),
                k=k), **kw)
        _, streams[kv_impl] = drain(teng, reqs)
        assert teng.stats["spec_proposed"] > 0
    assert streams["kernel"] == streams["reference"] == jout


# ---------------------------------------------------------------------------
# request and drain metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def obs_drains(smollm):
    """The pool-starved workload through both engines with a live
    Recorder and SpanTracer, and through the port's with obs off."""
    jcfg, tcfg, jp, tp = smollm
    reqs = workload(64)
    jrec = repro.obs.Recorder(tracer=repro.obs.SpanTracer())
    trec = repro_torch.obs.Recorder(tracer=repro_torch.obs.SpanTracer())
    jeng = repro.serve.ServeEngine(jcfg, jp, recorder=jrec, **STARVED)
    teng = repro_torch.serve.ServeEngine(tcfg, tp, recorder=trec,
                                         device="cpu", **STARVED)
    off = repro_torch.serve.ServeEngine(tcfg, tp, device="cpu", **STARVED)
    return {name: (eng, rec, *drain(eng, reqs)) for name, eng, rec in
            (("jax", jeng, jrec), ("port", teng, trec), ("off", off, None))}


def test_obs_counters_and_observation_counts_match_jax(obs_drains):
    jeng, jrec, jrids, jout = obs_drains["jax"]
    teng, trec, trids, tout = obs_drains["port"]
    assert tout == jout and teng.stats["preemptions"] > 0
    js, ts = jrec.snapshot(), trec.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["counters"]["serve_finished"] == len(trids)
    assert {k: v["count"] for k, v in ts["observations"].items()} == \
        {k: v["count"] for k, v in js["observations"].items()}
    assert ts["observations"]["serve_ttft_s"]["count"] == len(trids)
    assert ts["hist_counts"] == js["hist_counts"]
    marks = [e for e in trec.tracer.to_chrome_trace()["traceEvents"]
             if e.get("ph") == "i" and e["name"] == "preempt"]
    assert len(marks) == teng.stats["preemptions"]


def test_obs_gauges_and_events_match_jax(obs_drains):
    jeng, jrec, jrids, _ = obs_drains["jax"]
    teng, trec, trids, tout = obs_drains["port"]
    jg, tg = jrec.snapshot()["gauges"], trec.snapshot()["gauges"]
    assert set(tg) == set(jg)
    assert tg["serve_preemptions"] == teng.stats["preemptions"]
    assert 0.0 <= tg["serve_block_occupancy"] <= 1.0
    assert tg["serve_tokens_per_sec"] > 0
    done = {e["rid"]: e for e in trec.events if e["kind"] == "request_done"}
    assert sorted(done) == sorted(trids) == sorted(
        e["rid"] for e in jrec.events if e["kind"] == "request_done")
    for rid, toks in zip(trids, tout):
        req, ev = teng.completed[rid], done[rid]
        assert ev["tokens"] == len(toks)
        assert ev["ttft_s"] == pytest.approx(req.first_token_s - req.submit_s)
        assert 0.0 < ev["ttft_s"] <= ev["latency_s"]
    assert [e["kind"] for e in trec.events].count("drain_done") == 1
    jdd = next(e for e in jrec.events if e["kind"] == "drain_done")
    tdd = next(e for e in trec.events if e["kind"] == "drain_done")
    assert set(tdd) == set(jdd)


def test_streams_identical_obs_on_off(obs_drains):
    assert obs_drains["off"][3] == obs_drains["port"][3]
    assert host_stats(obs_drains["off"][0].stats) == \
        host_stats(obs_drains["port"][0].stats)
    assert obs_drains["off"][0].recorder.enabled is False


@pytest.mark.parametrize("mode", ["cohort", "continuous"])
def test_other_modes_record_every_request(mode, smollm):
    _, tcfg, _, tp = smollm
    rec = repro_torch.obs.Recorder()
    eng = repro_torch.serve.ServeEngine(tcfg, tp, mode=mode, capacity=32,
                                        max_batch=2, recorder=rec,
                                        device="cpu")
    rids, _ = drain(eng, workload(64))
    snap = rec.snapshot()
    assert snap["counters"]["serve_finished"] == len(rids)
    assert snap["observations"]["serve_latency_s"]["count"] == len(rids)
    assert snap["gauges"]["serve_prefills"] == eng.stats["prefills"]


def cli_files(main, argv, tmp_path, name, monkeypatch, capsys):
    mdir, tdir = tmp_path / f"{name}_m", tmp_path / f"{name}_t"
    argv = argv + ["--metrics", str(mdir), "--trace-dir", str(tdir)]
    if name == "jax":
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        main()
    else:
        main(argv + ["--device", "cpu"])
    printed = [ln.split("obs: ", 1)[1] for ln in
               capsys.readouterr().out.splitlines() if ln.startswith("obs: ")]
    kinds = {json.loads(ln)["kind"]
             for ln in open(mdir / "metrics.jsonl")}
    prom = {ln.split()[2] for ln in open(mdir / "metrics.prom")
            if ln.startswith("# TYPE")}
    trace = json.load(open(tdir / "trace.json"))
    return ([os.path.basename(p) for p in printed], kinds, prom,
            {e["name"] for e in trace["traceEvents"]})


def test_cli_metrics_and_trace_files_match_jax(tmp_path, monkeypatch,
                                               capsys):
    """``--mode cohort --metrics DIR --trace-dir DIR`` writes the JAX CLI's
    files with its event kinds, metric names and span names, and prints
    their paths as it does."""
    from repro.launch.serve import main as jax_main
    from repro_torch.launch.serve import main as torch_main

    argv = ["--arch", "smollm-360m", "--reduced", "--mode", "cohort",
            "--requests", "3", "--max-new", "3", "--max-batch", "2"]
    j = cli_files(jax_main, argv, tmp_path, "jax", monkeypatch, capsys)
    t = cli_files(torch_main, argv, tmp_path, "port", monkeypatch, capsys)
    assert t == j
    assert t[0] == ["metrics.jsonl", "metrics.prom", "trace.json"]
    assert {"request_done", "drain_done"} <= t[1]
