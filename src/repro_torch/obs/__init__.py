"""repro_torch.obs — only the no-op recorder so far; the live recorder,
tracer and metric exports wait on ``ROADMAP.md`` (queue 1, obs)."""
from repro_torch.obs.recorder import NullRecorder

__all__ = ["NullRecorder"]
