"""Host-side metric recording and export: the hub of ``repro_torch.obs``.

A recorder is the single object the engines talk to:

* the **training** :class:`~repro_torch.core.engine.Engine` drains its
  in-chunk :class:`~repro_torch.obs.metrics.MetricSet` accumulators into
  :meth:`Recorder.record_drain` once per fused chunk and pushes
  eval-boundary ``RunResult`` metrics through :meth:`Recorder.metrics`;
* the **serving** :class:`~repro_torch.serve.engine.ServeEngine` calls the
  same interface (with the default :class:`NullRecorder`).

Everything is plain Python/numpy, called only at chunk boundaries, where
the engines already touch the host. :class:`NullRecorder` is the default
everywhere and makes every call a no-op.

Exports: an append-only **JSONL event log** (one JSON object per line,
every ``event()``/``metrics()``/``record_drain()`` call), a **Prometheus
text-format snapshot** (:meth:`Recorder.prometheus_text` /
:meth:`Recorder.write_prometheus`), and the in-process
:meth:`Recorder.snapshot` dict.

A copy of ``repro.obs.recorder`` (the port imports nothing of the JAX
package): the same calls give the same JSONL fields, Prometheus text and
snapshot.
"""
from __future__ import annotations

import json
import os
import re
import time
from contextlib import nullcontext

import numpy as np

from repro_torch.obs.tracing import SpanTracer

_NULL_CM = nullcontext()
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _key(name: str, labels: dict) -> tuple[str, tuple]:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    return str(o)


class NullRecorder:
    """The default: observability off. Every method is a no-op; ``span``
    returns a shared null context manager so instrumented call sites cost a
    dict lookup and nothing else."""

    enabled = False
    tracer = None

    def counter_add(self, name, value=1.0, **labels):
        pass

    def gauge_set(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def hist_add(self, name, counts, **labels):
        pass

    def metrics(self, values, step=None):
        pass

    def record_drain(self, rows, step=None):
        pass

    def event(self, kind, **fields):
        pass

    def span(self, name, **attrs):
        return _NULL_CM

    def instant(self, name, **attrs):
        pass

    def snapshot(self) -> dict:
        return {}

    def prometheus_text(self) -> str:
        return ""

    def flush(self):
        pass

    def close(self):
        pass


class Recorder(NullRecorder):
    """Live recorder: counters / gauges / observations / histograms in
    process, optional JSONL event log, optional :class:`SpanTracer`."""

    enabled = True

    def __init__(self, jsonl_path: str | None = None, tracer=None,
                 max_observations: int = 100_000):
        self.tracer = tracer
        self._jsonl_path = jsonl_path
        self._jsonl = None
        self._max_obs = max_observations
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        self.observations: dict[tuple, list[float]] = {}
        self.hist_counts: dict[tuple, np.ndarray] = {}
        self.events: list[dict] = []

    # -- primitives ---------------------------------------------------------

    def counter_add(self, name, value=1.0, **labels):
        k = _key(name, labels)
        self.counters[k] = self.counters.get(k, 0.0) + float(value)

    def gauge_set(self, name, value, **labels):
        self.gauges[_key(name, labels)] = float(value)

    def observe(self, name, value, **labels):
        vs = self.observations.setdefault(_key(name, labels), [])
        if len(vs) < self._max_obs:
            vs.append(float(value))

    def hist_add(self, name, counts, **labels):
        k = _key(name, labels)
        c = np.asarray(counts, np.int64)
        if k in self.hist_counts:
            self.hist_counts[k] = self.hist_counts[k] + c
        else:
            self.hist_counts[k] = c.copy()

    # -- bulk entry points (the engines call these) -------------------------

    def metrics(self, values: dict, step=None):
        """Scalar metrics -> gauges, plus one JSONL ``metrics`` event."""
        fields = {}
        for k, v in values.items():
            a = np.asarray(v)
            if a.ndim == 0:
                self.gauge_set(k, float(a))
                fields[k] = float(a)
            else:
                fields[k] = a
        self.event("metrics", step=step, **fields)

    def record_drain(self, rows, step=None):
        """Fold one chunk's :meth:`MetricSet.drain` rows in by kind:
        counters accumulate, means become gauges (last chunk wins — the
        JSONL log keeps the trajectory), histograms accumulate bin counts."""
        fields = {}
        for name, kind, value in rows:
            if kind == "counter":
                self.counter_add(name, value)
            elif kind == "hist":
                self.hist_add(name, value)
            else:
                self.gauge_set(name, value)
            fields[name] = value
        self.event("drain", step=step, **fields)

    def event(self, kind, **fields):
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        self.events.append(ev)
        if self._jsonl_path is not None:
            if self._jsonl is None:
                os.makedirs(os.path.dirname(self._jsonl_path) or ".",
                            exist_ok=True)
                self._jsonl = open(self._jsonl_path, "a")
            self._jsonl.write(json.dumps(ev, default=_json_default) + "\n")

    # -- spans (delegate to the tracer when present) ------------------------

    def span(self, name, **attrs):
        if self.tracer is None:
            return _NULL_CM
        return self.tracer.span(name, **attrs)

    def instant(self, name, **attrs):
        if self.tracer is not None:
            self.tracer.instant(name, **attrs)

    # -- export -------------------------------------------------------------

    @staticmethod
    def _render(name: str, labels: tuple) -> str:
        n = _NAME_RE.sub("_", name)
        if not labels:
            return n
        inner = ",".join(f'{_NAME_RE.sub("_", k)}="{v}"' for k, v in labels)
        return f"{n}{{{inner}}}"

    def snapshot(self) -> dict:
        """In-process view: counters/gauges flat, observation summaries
        (count/mean/p50/p95/max), raw histogram bin counts."""

        def flat(d):
            return {self._render(n, ls): v for (n, ls), v in sorted(d.items())}

        summaries = {}
        for (n, ls), vs in sorted(self.observations.items()):
            a = np.asarray(vs)
            summaries[self._render(n, ls)] = {
                "count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)), "max": float(a.max()),
            } if a.size else {"count": 0}
        return {"counters": flat(self.counters), "gauges": flat(self.gauges),
                "observations": summaries,
                "hist_counts": {self._render(n, ls): c.tolist()
                                for (n, ls), c in
                                sorted(self.hist_counts.items())}}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format: counters, gauges, observation
        summaries (quantile series + _count/_sum), histograms as cumulative
        ``_bucket{le=...}`` series."""
        out: list[str] = []
        typed: set[str] = set()

        def head(name, ptype):
            n = _NAME_RE.sub("_", name)
            if n not in typed:
                typed.add(n)
                out.append(f"# TYPE {n} {ptype}")
            return n

        for (n, ls), v in sorted(self.counters.items()):
            head(n, "counter")
            out.append(f"{self._render(n, ls)} {v:.17g}")
        for (n, ls), v in sorted(self.gauges.items()):
            head(n, "gauge")
            out.append(f"{self._render(n, ls)} {v:.17g}")
        for (n, ls), vs in sorted(self.observations.items()):
            if not vs:
                continue
            a = np.asarray(vs)
            head(n, "summary")
            for q in (0.5, 0.95, 0.99):
                lq = ls + (("quantile", f"{q:g}"),)
                out.append(f"{self._render(n, lq)} "
                           f"{float(np.percentile(a, q * 100)):.17g}")
            out.append(f"{_NAME_RE.sub('_', n)}_count {a.size}")
            out.append(f"{_NAME_RE.sub('_', n)}_sum {float(a.sum()):.17g}")
        for (n, ls), c in sorted(self.hist_counts.items()):
            head(n, "histogram")
            cum = 0
            for i, v in enumerate(c.tolist()):
                cum += int(v)
                lb = ls + (("le", str(i)),)
                out.append(f"{self._render(n + '_bucket', lb)} {cum}")
            lb = ls + (("le", "+Inf"),)
            out.append(f"{self._render(n + '_bucket', lb)} {cum}")
            out.append(f"{_NAME_RE.sub('_', n)}_count {cum}")
        return "\n".join(out) + ("\n" if out else "")

    def write_prometheus(self, path: str) -> str:
        """Write the snapshot; ``path`` may be a directory (then
        ``metrics.prom`` inside it). Returns the file path written."""
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "metrics.prom")
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.prometheus_text())
        return path

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None


def cli_recorder(metrics_dir: str | None = None,
                 trace_dir: str | None = None):
    """Build ``(recorder, finalize)`` from the launch CLIs' ``--metrics`` /
    ``--trace-dir`` flags. Both unset -> :class:`NullRecorder` (zero cost).
    ``finalize()`` writes the Prometheus snapshot (+ the Chrome trace when
    tracing), closes the JSONL log, and returns the list of paths written —
    what the CI smoke run uploads as artifacts."""
    if metrics_dir is None and trace_dir is None:
        return NullRecorder(), lambda: []
    tracer = SpanTracer() if trace_dir else None
    jsonl = (os.path.join(metrics_dir, "metrics.jsonl")
             if metrics_dir else None)
    rec = Recorder(jsonl_path=jsonl, tracer=tracer)

    def finalize() -> list[str]:
        paths = []
        if metrics_dir:
            if jsonl and rec.events:
                paths.append(jsonl)
            paths.append(rec.write_prometheus(
                os.path.join(metrics_dir, "metrics.prom")))
        if tracer is not None:
            # --trace-dir is always a directory (it may not exist yet, so
            # spell out the file name rather than relying on isdir sniffing)
            paths.append(tracer.write(os.path.join(trace_dir, "trace.json")))
        rec.close()
        return paths

    return rec, finalize
