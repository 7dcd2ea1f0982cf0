"""Two departures of the port's serving from the JAX package's, both in the
hybrid family (reduced ``recurrentgemma-2b``, JAX ``PRNGKey(0)`` weights
carried over with ``params_from_jax``):

* ``ServeEngine(cfg, params)`` with no ``mode`` serves in the JAX engine's
  default mode, continuous, and gives its streams;
* prompts shorter than ``conv1d_width - 1`` (3 tokens). Prefill keeps the
  last 3 pre-convolution inputs as the decode conv state, and a 1- or
  2-token prompt has fewer. The port left-pads them with zeros, the inputs
  ``causal_conv1d`` pads a prompt with. The JAX package keeps the short
  state (``repro/models/transformer.py:384``): its serial decode then
  raises, and its engine writes the short state over part of the slot's
  previous row, so its engine gives ``[6, 367, 41, 483, 234]`` for prompt
  ``[5]``. Neither JAX serving path is the oracle here. The oracle is the
  reference's own: greedy decoding by a full JAX ``prefill`` of the growing
  sequence, which the port's engine must equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "recurrentgemma-2b"
KW = {"capacity": 48, "max_batch": 2, "decode_chunk": 3}


@pytest.fixture(scope="module")
def model():
    jcfg = repro.configs.get(ARCH).reduced()
    tcfg = repro_torch.configs.get(ARCH).reduced()
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def drain(eng, reqs):
    rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
    res = eng.run()
    return [res[r] for r in rids]


def greedy_by_prefill(jcfg, jparams, prompt, n):
    """The reference's oracle: each token is the argmax of a full JAX
    prefill of the prompt and the tokens before it."""
    seq = list(prompt)
    for _ in range(n):
        logits, _ = repro.models.prefill(
            jcfg, jparams, jnp.asarray([seq], jnp.int32), KW["capacity"])
        seq.append(int(jnp.argmax(logits[0, -1])))
    return seq[len(prompt):]


def test_default_mode_is_the_jax_engines_and_serves_hybrid(model):
    jcfg, tcfg, jparams, tparams = model
    jeng = repro.serve.ServeEngine(jcfg, jparams, **KW)
    teng = repro_torch.serve.ServeEngine(tcfg, tparams, device="cpu", **KW)
    assert teng.mode == jeng.mode == "continuous"
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 512, size=int(n)), 4) for n in (9, 5, 12)]
    assert drain(teng, reqs) == drain(jeng, reqs)
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("prompt,want", [
    ([5], [6, 425, 483, 55, 290]),
    ([5, 6], [425, 483, 55, 290, 22]),
    ([5, 6, 7], None),     # a full conv window: no padding needed
])
def test_short_prompt_decodes_as_full_prefill(model, prompt, want):
    """A 20-token request fills slot 0 first, so the short prompt's slot
    held another request's conv rows before it; budget 5."""
    jcfg, tcfg, jparams, tparams = model
    oracle = greedy_by_prefill(jcfg, jparams, prompt, 5)
    if want is not None:
        assert oracle == want
    eng = repro_torch.serve.ServeEngine(tcfg, tparams, device="cpu", **KW)
    first = np.random.default_rng(0).integers(0, 512, size=20)
    streams = drain(eng, [(first, 2), (np.asarray(prompt), 5)])
    assert streams[1] == oracle
