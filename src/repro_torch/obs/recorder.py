"""The recorder interface the serving engine talks to, with observability
off: a copy of ``repro.obs.recorder.NullRecorder``. Every method is a no-op;
``span`` returns a shared null context manager."""
from __future__ import annotations

from contextlib import nullcontext

_NULL_CM = nullcontext()


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
