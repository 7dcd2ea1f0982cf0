"""The port's ``repro_torch.obs`` against the JAX package's ``repro.obs``:
``Recorder``, ``cli_recorder`` and ``SpanTracer`` given the same calls
give the same snapshot, Prometheus text, JSONL log and Chrome trace (all
but the clock's fields: ``ts`` and ``dur``); ``MetricSet`` accumulates,
drains and resets as the JAX one does, in place on device tensors; the
staleness histogram counts as ``bincount`` does, with a fixed length; the
trainer set names the same metrics. The obs modules pass the JAX
package's AST lint.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs as robs  # noqa: E402
import repro.obs.metrics as rmetrics  # noqa: E402
import repro_torch.obs as pobs  # noqa: E402
import repro_torch.obs.metrics as pmetrics  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
CLOCK = ("ts", "dur")


def drive(pkg, rec):
    """The same calls on a recorder of either package."""
    rec.counter_add("requests", 2, route="a")
    rec.counter_add("requests", 1.5, route="a")
    rec.counter_add("requests", route="b")
    rec.gauge_set("queue depth", 3, pool="x")
    for v in (0.5, 0.25, 2.0, 1.0):
        rec.observe("ttft_s", v)
    rec.hist_add("ages", [1, 2, 0])
    rec.hist_add("ages", np.array([0, 1, 4]))
    rec.metrics({"loss": np.float32(0.5), "vec": np.arange(3)}, step=4)
    rec.record_drain([("bytes", "counter", 64.0), ("cons", "mean", 0.125),
                      ("train_staleness", "hist", np.array([3, 1]))], step=5)
    rec.event("run_done", algo="mdbo", steps=np.int64(7))
    with rec.span("train_chunk", t0=0, steps=5):
        with rec.span("eval", step=5):
            rec.instant("mark", n=1)


def without_clock(events):
    return [{k: v for k, v in e.items() if k not in CLOCK} for e in events]


def test_recorder_and_cli_recorder_match_the_reference(tmp_path):
    out = {}
    for name, pkg in (("jax", robs), ("torch", pobs)):
        base = tmp_path / name
        rec, finalize = pkg.cli_recorder(str(base / "m"), str(base / "t"))
        drive(pkg, rec)
        paths = [p.replace(str(base), "") for p in finalize()]
        jsonl = [json.loads(line) for line in
                 (base / "m" / "metrics.jsonl").read_text().splitlines()]
        trace = json.loads((base / "t" / "trace.json").read_text())
        out[name] = (paths, rec.snapshot(), rec.prometheus_text(),
                     without_clock(jsonl),
                     without_clock(trace["traceEvents"]),
                     trace["displayTimeUnit"])
    assert out["torch"] == out["jax"]
    paths, snap, prom = out["torch"][:3]
    assert paths == ["/m/metrics.jsonl", "/m/metrics.prom", "/t/trace.json"]
    assert snap["hist_counts"]["ages"] == [1, 3, 4]
    assert 'requests{route="a"} 3.5' in prom
    for pkg in (robs, pobs):
        rec, finalize = pkg.cli_recorder()
        assert not rec.enabled and finalize() == []


def test_tracer_and_null_recorder_match_the_reference(tmp_path):
    events = {}
    for name, pkg in (("jax", robs), ("torch", pobs)):
        tr = pkg.SpanTracer(process_name="t")
        with pytest.raises(RuntimeError):
            with tr.span("outer", step=1):
                tr.instant("mark")
                raise RuntimeError("boom")
        path = tr.write(str(tmp_path / name) + "/")
        assert path.endswith("trace.json")
        events[name] = without_clock(tr.to_chrome_trace()["traceEvents"])
        null = pkg.NullRecorder()
        assert not null.enabled and null.snapshot() == {}
        with null.span("x"):
            null.counter_add("c")
    assert events["torch"] == events["jax"]


def test_metric_set_accumulates_drains_and_resets_like_the_reference():
    """Two steps of a counter, a mean and a histogram, in place on device
    tensors; the drain equals the JAX set's, and ``reset`` zeroes the very
    tensors the steps add into."""
    def specs(pkg, hist):
        return pkg.MetricSet([
            pkg.MetricSpec("ones", "counter", lambda ctx: 1.0),
            pkg.MetricSpec("val", "mean", lambda ctx: ctx["new"]),
            pkg.MetricSpec("ages", "hist", lambda ctx: hist(ctx["old"]),
                           bins=3)])

    ages = np.array([0, 2, 2, 9], np.int32)
    rset = specs(rmetrics,
                 lambda a: jnp.bincount(jnp.clip(a, 0, 2), length=3))
    pset = specs(pmetrics, lambda a: (
        a.clamp(0, 2)[:, None] == torch.arange(3)).sum(0, dtype=torch.int32))
    racc, pacc = rset.init(), pset.init("cpu")
    buffers = [t.data_ptr() for t in torch.utils._pytree.tree_leaves(pacc)]
    for v in (2.0, 4.0):
        racc = rset.update(racc, {"old": jnp.asarray(ages),
                                  "new": jnp.float32(v)})
        assert pset.update(pacc, {"old": torch.from_numpy(ages),
                                  "new": torch.tensor(v)}) is None
    rrows, prows = rset.drain(racc), pset.drain(pacc)
    assert [(n, k) for n, k, _ in prows] == [(n, k) for n, k, _ in rrows]
    for (_, _, p), (_, _, r) in zip(prows, rrows):
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    assert prows[2][2].dtype == np.int64
    pset.reset(pacc)
    assert [t.data_ptr() for t in torch.utils._pytree.tree_leaves(pacc)] \
        == buffers
    assert all(float(t.abs().sum()) == 0
               for t in torch.utils._pytree.tree_leaves(pacc))
    with pytest.raises(ValueError):
        pmetrics.MetricSpec("h", "hist", lambda ctx: 0)
    with pytest.raises(ValueError):
        pmetrics.MetricSpec("x", "gauge", lambda ctx: 0.0)
    with pytest.raises(ValueError, match="duplicate"):
        pmetrics.MetricSet([pmetrics.MetricSpec("a", "counter", len)] * 2)


def test_staleness_histogram_counts_as_bincount():
    """Both edges of every site, clipped into the last bin, as the
    reference's ``bincount(clip(ages), length=bins)`` sum."""
    rng = np.random.default_rng(0)
    sts = [{k: rng.integers(0, 6, 8).astype(np.int32)
            for k in ("age_left", "age_right")} for _ in range(3)]
    want = rmetrics.staleness_hist_fn(4)(
        {"mix_states": [{k: jnp.asarray(v) for k, v in s.items()}
                        for s in sts]})
    got = pmetrics.staleness_hist_fn(4)(
        {"mix_states": [{k: torch.from_numpy(v) for k, v in s.items()}
                        for s in sts]})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pmetrics.staleness_hist_fn(4)({"mix_states": None}) == 0


def test_trainer_metric_set_names_and_bytes_match_the_reference():
    """The same metric names and the same static bytes a step, from the
    same shapes (the port's sites are meta tensors)."""
    from repro.core.mdbo import MDBOState as RState
    from repro_torch.core.async_gossip import AsyncGossipMix
    from repro_torch.core.mdbo import MDBOState as PState

    W = np.full((4, 4), 0.25)
    shapes = [(4, 16), (4, 16, 2), (4, 16), (4, 16, 2)]
    rsites = [jnp.zeros(s, jnp.bfloat16 if i else jnp.float32)
              for i, s in enumerate(shapes)]
    psites = [torch.empty(s, dtype=torch.bfloat16 if i else torch.float32,
                          device="meta") for i, s in enumerate(shapes)]
    rstate = RState(*[jnp.zeros(2)] * 6)
    pstate = PState(*[torch.zeros(2)] * 6)
    for ratio, weights in ((0.25, None), (1.0, W)):
        rset = rmetrics.trainer_metric_set(rstate, mix_sites=rsites,
                                           ratio=ratio, weights=weights)
        pset = pmetrics.trainer_metric_set(pstate, mix_sites=psites,
                                           ratio=ratio, weights=weights)
        assert [(s.name, s.kind) for s in pset.specs] == [
            (s.name, s.kind) for s in rset.specs]
        assert pset.specs[-1].fn({}) == float(rset.specs[-1].fn({}))
    pset = pmetrics.trainer_metric_set(
        pstate, mix=AsyncGossipMix(4, tau=2, device="cpu"), mix_sites=psites)
    assert (pset.specs[-1].name, pset.specs[-1].bins) == ("train_staleness",
                                                          3)


def test_obs_modules_pass_the_reference_ast_lint():
    from repro.analysis.ast_rules import lint_source

    files = sorted((ROOT / "src" / "repro_torch" / "obs").glob("*.py"))
    assert len(files) == 4
    for f in files:
        text = f.read_text()
        assert "noqa" not in text
        assert lint_source(text, str(f.relative_to(ROOT))) == []
