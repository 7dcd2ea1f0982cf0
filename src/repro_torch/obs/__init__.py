"""``repro_torch.obs`` — telemetry for the training Engine, the counterpart
of ``repro.obs``:

* :mod:`repro_torch.obs.metrics` — :class:`MetricSpec`/:class:`MetricSet`
  accumulators on the device, updated by every step of a fused chunk
  (inside its CUDA graph on the card) and drained at chunk boundaries.
* :mod:`repro_torch.obs.tracing` — the host-side :class:`SpanTracer`
  (Chrome trace-event JSON for Perfetto) and :func:`torch_profile`, a
  ``torch.profiler`` device trace (the counterpart of ``jax_profile``).
* :mod:`repro_torch.obs.recorder` — :class:`Recorder`/:class:`NullRecorder`:
  counters, gauges, latency observations, histograms; JSONL event log,
  Prometheus text snapshot, in-process ``snapshot()``; ``cli_recorder``
  for the launch CLI's ``--metrics``/``--trace-dir``.

Not ported: ``obs/tap.py`` (``jax.debug.callback`` has no meaning inside a
CUDA graph replay; ``ROADMAP.md``, queue 1, item 7).
"""
from repro_torch.obs.metrics import (MetricSet, MetricSpec, staleness_hist_fn,
                                     tree_diff_l2, tree_l2, trainer_metric_set)
from repro_torch.obs.recorder import NullRecorder, Recorder, cli_recorder
from repro_torch.obs.tracing import SpanTracer, torch_profile

__all__ = [
    "MetricSet", "MetricSpec", "NullRecorder", "Recorder", "SpanTracer",
    "cli_recorder", "staleness_hist_fn", "trainer_metric_set",
    "torch_profile", "tree_diff_l2", "tree_l2",
]
