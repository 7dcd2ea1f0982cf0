"""The port's continuous-batching engine vs the JAX package's.

``ServeEngine(mode="continuous")`` streams and ``stats`` must equal the JAX
engine's on identical weights (carried over with ``params_from_jax``), for
reduced ``recurrentgemma-2b`` (the hybrid family's ``blocks`` tree of rings
and recurrent state), reduced ``smollm-360m`` (dense) and reduced
``rwkv6-1.6b`` (the ssm family's ``state`` tree), with more
requests than slots so that requests are admitted mid-decode. The reference
pins its own continuous mode to serial decode
(``tests/test_scheduler.py:186`` and ``:223``). No EOS is set: the
reference's EOS tests fail under this jax version (``ROADMAP.md`` queue 3).
Below the engine, the slot-cache helpers and one fused decode chunk are held
against the JAX package's.
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
import repro_torch.models  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro.serve.batch import gather_slot as jax_gather_slot  # noqa: E402
from repro.serve.batch import init_slot_cache as jax_init_slot_cache  # noqa: E402
from repro.serve.batch import slot_axes  # noqa: E402
from repro.serve.batch import write_slot as jax_write_slot  # noqa: E402
from repro.serve.steps import make_decode_step as jax_make_decode  # noqa: E402
from repro.serve.steps import make_fused_decode as jax_make_fused  # noqa: E402
from repro_torch.serve.batch import (gather_slot, init_slot_cache,  # noqa: E402
                                     write_slot)
from repro_torch.serve.steps import (make_decode_step,  # noqa: E402
                                     make_fused_decode)
from repro_torch.weights import params_from_jax  # noqa: E402

# f32 cache leaves through 2-3 layers: matmul summation order (XLA's dot vs
# oneDNN), ~1e-7 relative on O(1) values; 1e-4 leaves two decades.
TOL = 1e-4
ARCHS = ("recurrentgemma-2b", "smollm-360m", "rwkv6-1.6b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = repro.configs.get(request.param).reduced()
    tcfg = repro_torch.configs.get(request.param).reduced()
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def tflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tflat(v, f"{prefix}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(tflat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: np.asarray(torch.as_tensor(tree).float())}


def drain_both(model, reqs, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {"capacity": 48, "max_batch": 2, "decode_chunk": 3, **kw}
    jeng = repro.serve.ServeEngine(jcfg, jparams, mode="continuous", **kw)
    teng = repro_torch.serve.ServeEngine(tcfg, tparams, mode="continuous",
                                         device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
        res = eng.run()
        out.append([res[r] for r in rids])
    assert out[1] == out[0]
    assert teng.stats == jeng.stats
    return teng, out[1]


def test_streams_and_stats_match_jax_mid_decode_admission(model):
    """Six requests over two slots, budgets 1-9, prompts of 3-89 tokens:
    requests are admitted while others decode, a budget of 1 finishes at
    prefill, and prompts run past the hybrid family's window of 64 and past
    the 48-position ring, so the ring of ``_kv_to_cache`` is rolled (the
    ssm family keeps no positions and ignores ``capacity``)."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, size=int(n)), int(b))
            for n, b in zip(rng.integers(3, 90, size=6), (4, 9, 1, 7, 5, 2))]
    teng, streams = drain_both(model, reqs)
    assert [len(s) for s in streams] == [b for _, b in reqs]
    assert teng.stats["prefills"] == 6
    assert teng.stats["peak_concurrency"] == 2


def test_streams_match_jax_in_the_references_other_families_setting(model):
    """The setting of the reference's
    ``tests/test_scheduler.py::test_continuous_matches_serial_other_families``
    (its rwkv6 and recurrentgemma cases): capacity 32, ``max_batch`` 2,
    ``decode_chunk`` 2, three prompts of 3-7 tokens, 4 new tokens each."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=rng.integers(3, 8))
               for _ in range(3)]
    teng, streams = drain_both(model, [(p, 4) for p in prompts],
                               capacity=32, max_batch=2, decode_chunk=2)
    assert [len(s) for s in streams] == [4, 4, 4]
    assert teng.stats["prefills"] == 3


def test_streams_match_jax_ring_of_the_window(model):
    """A capacity above the hybrid family's window: its rings hold the
    window (64) and decode wraps them."""
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, size=int(n)), 6) for n in (70, 5, 64)]
    drain_both(model, reqs, capacity=96, max_batch=3, decode_chunk=4)


def test_stream_deltas_and_unported_modes(model):
    _, tcfg, _, tparams = model
    eng = repro_torch.serve.ServeEngine(tcfg, tparams, mode="continuous",
                                        capacity=32, max_batch=2,
                                        device="cpu")
    rids = [eng.submit(np.arange(1, 6), 5), eng.submit(np.arange(2, 5), 3),
            eng.submit(np.arange(7, 12), 4)]
    seen = {r: [] for r in rids}
    dones = set()
    for rid, delta, done in eng.stream():
        assert rid not in dones
        seen[rid] += delta
        if done:
            dones.add(rid)
    assert dones == set(rids) and [len(seen[r]) for r in rids] == [5, 3, 4]
    # the cohort drain is ported (tests/test_torch_serve_modes.py) and has
    # no chunk boundaries to stream at, as in the JAX engine
    cohort = repro_torch.serve.ServeEngine(tcfg, tparams, mode="cohort",
                                           device="cpu")
    with pytest.raises(ValueError, match="stream"):
        next(cohort.stream())
    with pytest.raises(ValueError, match="mode must be"):
        repro_torch.serve.ServeEngine(tcfg, tparams, mode="nope",
                                      device="cpu")


def test_hybrid_paged_mode_raises_the_jax_error():
    jcfg = repro.configs.get("recurrentgemma-2b").reduced()
    tcfg = repro_torch.configs.get("recurrentgemma-2b").reduced()
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    msgs = []
    for eng, cfg, p, kw in ((repro.serve.ServeEngine, jcfg, jparams, {}),
                            (repro_torch.serve.ServeEngine, tcfg, tparams,
                             {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            eng(cfg, p, mode="paged", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "full-attention" in msgs[0]


def test_write_then_gather_slot_matches_jax(model):
    """Slot-cache layout, ``write_slot`` and ``gather_slot`` against the
    JAX package's, which find each leaf's slot axis by abstract
    evaluation."""
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(2).integers(0, 512, size=(1, 70))
    _, jreq = repro.models.prefill(jcfg, jparams,
                                   jnp.asarray(toks, jnp.int32), 48)
    _, treq = repro_torch.models.prefill(
        tcfg, tparams, torch.as_tensor(toks, dtype=torch.int32), 48)
    axes = slot_axes(jcfg, 48, params=jparams)
    jslots = jax_write_slot(jax_init_slot_cache(jcfg, 3, 48), jreq, 1, axes)
    tslots = write_slot(init_slot_cache(tcfg, 3, 48, device="cpu"), treq, 1)
    jf, tf = jflat(jslots), tflat(tslots)
    assert {k: v.shape for k, v in tf.items()} == \
        {k: v.shape for k, v in jf.items()}
    for k in jf:
        assert float(np.max(np.abs(tf[k] - jf[k]))) < TOL, k
    back = gather_slot(tslots, 1)
    assert back["idx"] == 70
    jback = jflat(jax_gather_slot(jslots, 1, axes))
    for k, v in tflat(back).items():
        assert float(np.max(np.abs(v - jback[k]))) < TOL, k
    assert gather_slot(tslots, 0)["idx"] == 0


def test_fused_decode_chunk_matches_jax(model):
    """One fused chunk over three slots — two live at their own positions,
    one dead — with budgets that run out inside the chunk."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(3)
    axes = slot_axes(jcfg, 48, params=jparams)
    jslots = jax_init_slot_cache(jcfg, 3, 48)
    tslots = init_slot_cache(tcfg, 3, 48, device="cpu")
    for i, n in ((0, 70), (2, 9)):
        toks = rng.integers(0, 512, size=(1, n))
        _, jreq = repro.models.prefill(jcfg, jparams,
                                       jnp.asarray(toks, jnp.int32), 48)
        _, treq = repro_torch.models.prefill(
            tcfg, tparams, torch.as_tensor(toks, dtype=torch.int32), 48)
        jslots = jax_write_slot(jslots, jreq, i, axes)
        write_slot(tslots, treq, i)
    tok = np.array([5, 0, 9], np.int32)
    live = np.array([True, False, True])
    remaining = np.array([2, 0, 6], np.int32)
    jout = jax.jit(jax_make_fused(jcfg, axes, 4, None))(
        jparams, jnp.asarray(tok), jslots, jnp.asarray(live),
        jnp.asarray(remaining))
    tout = make_fused_decode(tcfg, 4, None)(
        tparams, torch.as_tensor(tok), tslots, torch.as_tensor(live),
        torch.as_tensor(remaining))
    for j in (0, 2, 3, 4, 5):   # tok, live, remaining, tokens, emitted
        assert np.array_equal(np.asarray(tout[j]), np.asarray(jout[j])), j
    jf, tf = jflat(jout[1]), tflat(tout[1])
    for k in jf:
        assert float(np.max(np.abs(tf[k] - jf[k]))) < TOL, k


def test_decode_step_matches_jax(model):
    """``make_decode_step``: one greedy token for a batch of two at one
    position, from a prefilled cache."""
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(4).integers(0, 512, size=(2, 70))
    _, jc = repro.models.prefill(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                                 48)
    _, tc = repro_torch.models.prefill(
        tcfg, tparams, torch.as_tensor(toks, dtype=torch.int32), 48)
    last = np.array([[3], [7]], np.int32)
    jtok, jlogits, jc = jax_make_decode(jcfg)(jparams, jnp.asarray(last), jc)
    ttok, tlogits, tc = make_decode_step(tcfg)(tparams,
                                               torch.as_tensor(last), tc)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert float(np.max(np.abs(tlogits.numpy() - np.asarray(jlogits)))) < TOL
    assert tc["idx"] == 71
