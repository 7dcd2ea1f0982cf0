"""Host-side span tracing: hierarchical spans on a monotonic clock, exported
as Chrome trace-event JSON (loadable in Perfetto / chrome://tracing).

Spans nest lexically via a context manager — a run looks like
``train_chunk`` and ``eval`` spans in turn; Perfetto renders the nesting
from the containment of the ``"ph": "X"`` complete events, so no explicit
parent ids are needed (everything runs on one host thread).

The clock is ``time.perf_counter_ns`` (monotonic, ns resolution) rebased to
the tracer's construction time, so timestamps are small microsecond floats
as the trace-event spec expects.

A copy of ``repro.obs.tracing.SpanTracer``: the same calls give the same
events. :func:`torch_profile` is the counterpart of the JAX package's
``jax_profile`` device-profiler bracket.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager


class SpanTracer:
    """Collects Chrome trace events; thread-safe appends, single process."""

    def __init__(self, process_name: str = "repro"):
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self.events: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": process_name},
        }]

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    @contextmanager
    def span(self, name: str, **args):
        """Time a block as one complete ('X') event; exceptions still close
        the span (the duration then covers up to the raise)."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            ev = {"name": name, "cat": "repro", "ph": "X", "ts": t0,
                  "dur": self._now_us() - t0, "pid": 0,
                  "tid": threading.get_ident() % 2 ** 31}
            if args:
                ev["args"] = dict(args)
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, **args):
        """A zero-duration marker (admissions, preemptions, eval ticks)."""
        ev = {"name": name, "cat": "repro", "ph": "i", "ts": self._now_us(),
              "s": "t", "pid": 0, "tid": threading.get_ident() % 2 ** 31}
        if args:
            ev["args"] = dict(args)
        with self._lock:
            self.events.append(ev)

    # -- export -------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the Chrome trace JSON; ``path`` may be a directory (then
        ``trace.json`` inside it). Returns the file path written."""
        if os.path.isdir(path) or path.endswith(os.sep):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "trace.json")
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path


@contextmanager
def torch_profile(trace_dir: str):
    """Opt-in ``torch.profiler`` bracket around a block: host operators and,
    on a card, its CUDA kernels, exported as a Chrome trace,
    ``torch_profile.json`` in ``trace_dir`` (beside the host-side
    :class:`SpanTracer`'s ``trace.json``). The counterpart of
    ``repro.obs.tracing.jax_profile``. Yields the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              "torch_profile.json"))
