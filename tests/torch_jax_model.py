"""The JAX model's ``prefill`` and ``decode_step``, compiled once per test
process for the port's CPU parity tests: ``jax.jit`` with the config (and
prefill's capacity) static, so a module's tests reuse each compiled
program, where calling the functions op by op traces and compiles their
layer scans again at every call. The arithmetic is the JAX model's own;
the compiled program may fuse its f32 elementwise operations, which moves
results by rounding only, far inside the tests' tolerances."""
import jax

import repro.models

prefill = jax.jit(repro.models.prefill, static_argnums=(0, 3))
decode_step = jax.jit(repro.models.decode_step, static_argnums=(0,))
