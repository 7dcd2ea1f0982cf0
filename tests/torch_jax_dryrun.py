"""``repro.launch.dryrun``, imported for the port's parity tests without
its side effect: on import it prepends
``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS`` (the JAX dry
run's own process needs the devices). A test process shares its JAX
backend with every other test module of its worker, so ``XLA_FLAGS`` is
put back as it was before any backend starts."""
import os

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

__all__ = ["jdry"]
