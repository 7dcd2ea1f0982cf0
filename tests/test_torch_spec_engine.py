"""The port's speculative ``ServeEngine`` vs the JAX package's, on the CPU.

``repro_torch`` ``ServeEngine(speculate=SpecConfig(...))`` must give the
JAX ``ServeEngine(mode="paged", kv_impl="kernel", speculate=...)``'s greedy
streams and host-side counters — ``spec_proposed``, ``spec_accepted``,
``draft_prefills``, ``preemptions``, ``prefills`` and the rest — and the
same streams as its own non-speculative engine: k of 1, 2 and 3, a
self-draft, forced preemption, shared prefixes on and off, EOS inside an
accepted window, and the draft checks. A seeded trace re-checks the JAX
package's allocator invariants after every allocator operation (the
speculative trim included).

The target is ``smollm-360m`` cut to 4 layers, layers past the first damped
by 0.3, and the draft its own first layer (``truncate_params``): it agrees
with the target on most proposals but not all, so ``spec_accepted`` is
neither 0 nor ``spec_proposed`` (a separately initialised random draft
agrees on none, which would compare 0 with 0). Both packages run the same
f32 weights, where the logits agree to ~1e-6, far below any top-2 gap these
seeds produce.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.serve  # noqa: E402
import repro_torch.serve.batch as torch_batch  # noqa: E402
from repro.analysis.contracts import allocator_invariants  # noqa: E402
from repro_torch.kernels import paged_attention, paged_attention_multi  # noqa: E402
from repro_torch.weights import params_from_jax, truncate_params  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

OVERRIDES = dict(n_heads=6, n_kv_heads=2, head_dim=32, n_layers=4)
DAMP = 0.3
STATS = ("prefills", "decode_dispatches", "decode_steps", "emitted_tokens",
         "preemptions", "peak_concurrency", "prefix_hits", "cow_forks",
         "prefill_tokens", "peak_blocks_in_use", "peak_shared_blocks",
         "spec_proposed", "spec_accepted", "draft_prefills")


@pytest.fixture(scope="module")
def model():
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(1))
    scale = np.ones((jcfg.n_layers,), np.float32)
    scale[1:] = DAMP
    jparams = {**jparams, "layers": jax.tree.map(
        lambda leaf: leaf * scale.reshape((-1,) + (1,) * (leaf.ndim - 1)),
        jparams["layers"])}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jdraft = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
              "layers": jax.tree.map(lambda leaf: leaf[:1],
                                     jparams["layers"])}
    return (jcfg, tcfg, jparams, tparams, jcfg.with_overrides(n_layers=1),
            tcfg.with_overrides(n_layers=1), jdraft,
            truncate_params(tparams, 1))


def spec_pair(model, k, self_draft=False):
    jcfg, tcfg, jparams, tparams, jdc, tdc, jdraft, tdraft = model
    if self_draft:
        return (repro.serve.SpecConfig(jcfg, jparams, k=k),
                repro_torch.serve.SpecConfig(tcfg, tparams, k=k))
    return (repro.serve.SpecConfig(jdc, jdraft, k=k),
            repro_torch.serve.SpecConfig(tdc, tdraft, k=k))


def drain_all(model, reqs, k, *, self_draft=False, alloc=None, **kw):
    """Drain ``reqs`` through the JAX spec engine, the port's spec engine
    and the port's non-spec engine; streams and counters must agree.
    Returns the port's spec engine and its streams."""
    jcfg, tcfg, jparams, tparams = model[:4]
    jspec, tspec = spec_pair(model, k, self_draft)
    kw = {"capacity": 48, "max_batch": 3, "decode_chunk": 4,
          "block_size": 8, **kw}
    jeng = repro.serve.ServeEngine(jcfg, jparams, mode="paged",
                                   kv_impl="kernel", speculate=jspec, **kw)
    teng = repro_torch.serve.ServeEngine(tcfg, tparams, mode="paged",
                                         speculate=tspec, device="cpu", **kw)
    base = repro_torch.serve.ServeEngine(tcfg, tparams, mode="paged",
                                         device="cpu", **kw)
    if alloc is not None:
        teng.pool.alloc = alloc(num_blocks=teng.pool.num_blocks,
                                block_size=kw["block_size"],
                                max_batch=kw["max_batch"],
                                capacity=kw["capacity"])
        if teng.prefix is not None:
            teng.prefix.alloc = teng.pool.alloc
    out = []
    launches = (paged_attention.launches, paged_attention_multi.launches)
    for eng in (jeng, teng, base):
        rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
        res = eng.run()
        out.append([res[r] for r in rids])
        assert eng.pool.free_blocks == eng.pool.num_blocks
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (paged_attention.launches, paged_attention_multi.launches) == \
        launches
    assert out[1] == out[0], "port spec streams != JAX spec streams"
    assert out[2] == out[1], "port spec streams != port non-spec streams"
    assert {s: teng.stats[s] for s in STATS} == \
        {s: jeng.stats[s] for s in STATS}
    st = teng.stats
    assert st["spec_rounds"] * k == st["spec_proposed"]
    assert st["decode_steps"] == st["decode_dispatches"] * (
        tspec.rounds_for(kw["decode_chunk"]) * (k + 1))
    return teng, out[1]


def mixed_requests(seed, n=6, budgets=(9, 7, 12, 5, 10, 8)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(rng.integers(3, 30))), int(b))
            for b in budgets[:n]]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_spec_streams_and_counters_match_jax(model, k):
    teng, streams = drain_all(model, mixed_requests(k), k)
    st = teng.stats
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert 0 < st["spec_full_rounds"] < st["spec_rounds"]
    assert st["draft_prefills"] == st["prefills"] + st["prefix_hits"]
    assert [len(s) for s in streams] == [b for _, b in mixed_requests(k)]


def test_self_draft_accepts_everything(model):
    """Drafting with the target itself: every proposal is accepted."""
    teng, _ = drain_all(model, mixed_requests(7, n=3), 3, self_draft=True)
    assert teng.stats["spec_accepted"] == teng.stats["spec_proposed"] > 0
    assert teng.stats["spec_full_rounds"] == teng.stats["spec_rounds"]


def test_spec_streams_survive_forced_preemption(model):
    """An undersized pool preempts speculative slots mid-decode; restarts
    run the draft prefill again and regenerate the same streams."""
    reqs = mixed_requests(1, n=5, budgets=(12, 10, 14, 9, 11))
    teng, _ = drain_all(model, reqs, 2, num_blocks=9, max_batch=3)
    st = teng.stats
    assert st["preemptions"] > 0, "workload must preempt"
    assert st["draft_prefills"] == len(reqs) + st["preemptions"]


@pytest.mark.parametrize("share", [True, False])
def test_spec_streams_with_prefix_sharing(model, share):
    """A common 16-token system prompt (two full blocks) under several
    tails, and an exact resubmission admitted while the original decodes:
    a prefix hit skips the target's prefill but not the draft's."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, 512, size=16)
    a = np.concatenate([system, rng.integers(0, 512, size=5)])
    reqs = [(a, 12),
            (np.concatenate([system, rng.integers(0, 512, size=3)]), 6),
            (a, 7),
            (np.concatenate([system, rng.integers(0, 512, size=7)]), 5)]
    teng, _ = drain_all(model, reqs, 3, share_prefix=share, max_batch=2)
    st = teng.stats
    if share:
        assert st["prefix_hits"] > 0 and st["cow_forks"] > 0
    else:
        assert st["prefix_hits"] == 0
    assert st["draft_prefills"] == len(reqs)


def test_spec_eos_inside_an_accepted_window(model):
    """EOS emitted by a verify row past the window's first truncates the
    stream where serial decode stops; rows after it are never emitted."""
    _, tcfg, _, tparams = model[:4]
    prompt = np.arange(5, 17)
    kw = dict(capacity=48, max_batch=2, block_size=8, decode_chunk=4)
    base = repro_torch.serve.ServeEngine(tcfg, tparams, mode="paged",
                                         device="cpu", **kw)
    rid = base.submit(prompt, 12)
    ref = base.run()[rid]
    k = 3
    for cut in range(2, len(ref)):
        if ref[cut] in ref[:cut]:
            continue
        # which verify row emits the EOS? the row index within its window
        eng = repro_torch.serve.ServeEngine(
            tcfg, tparams, mode="paged", device="cpu", eos_id=ref[cut],
            speculate=spec_pair(model, k)[1], **kw)
        rows = []
        chunk = eng._spec_decode

        def spy(*args):
            out = chunk(*args)
            emitted, tokens = out[6][:, 0], out[5][:, 0]
            rows.extend(int(r) % (k + 1) for r in
                        torch.nonzero(emitted & (tokens == ref[cut])))
            return out

        eng._spec_decode = spy
        r = eng.submit(prompt, 12)
        assert eng.run()[r] == ref[:cut + 1]
        if rows[-1] > 0:
            break
    else:
        pytest.fail("no EOS candidate lands inside a window")
    _, streams = drain_all(model, [(prompt, 12), (np.arange(3, 9), 8)], k,
                           eos_id=ref[cut], **kw)
    assert streams[0] == ref[:cut + 1]


class CheckedAllocator(torch_batch.BlockAllocator):
    """The port's allocator, re-checked against the JAX package's allocator
    invariants after every mutation, so a violation surfaces at the op
    that caused it."""

    def _check(self, op):
        msg = allocator_invariants(self, label=f"after {op}")
        assert msg is None, msg

    def ensure(self, slot, n_tokens):
        ok = super().ensure(slot, n_tokens)
        self._check(f"ensure({slot}, {n_tokens})")
        return ok

    def attach(self, slot, blocks):
        super().attach(slot, blocks)
        self._check(f"attach({slot})")

    def fork_for_write(self, slot, page):
        out = super().fork_for_write(slot, page)
        self._check(f"fork_for_write({slot}, {page})")
        return out

    def trim(self, slot, n_tokens):
        self.trims += 1
        freed = super().trim(slot, n_tokens)
        self._check(f"trim({slot}, {n_tokens})")
        return freed

    def release(self, slot):
        super().release(slot)
        self._check(f"release({slot})")

    trims = 0


@pytest.mark.parametrize("seed", range(2))
def test_spec_trace_keeps_allocator_invariants(model, seed):
    """A seeded speculative trace (random shapes, tight pool, EOS, shared
    prefixes): invariants hold after every allocator operation, the pool
    drains back, and streams and counters still match JAX's."""
    rng = np.random.default_rng(100 + seed)
    bs = int(rng.choice([4, 8]))
    k = int(rng.integers(1, 4))
    system = rng.integers(0, 512, size=bs)
    reqs = [(np.concatenate([system, rng.integers(0, 512,
                                                  size=int(rng.integers(1, 9)))]),
             int(rng.integers(1, 10))) for _ in range(5)]
    need = max(-(-(len(p) + b + k) // bs) for p, b in reqs)
    teng, _ = drain_all(model, reqs, k, block_size=bs,
                        decode_chunk=int(rng.integers(1, 6)),
                        max_batch=int(rng.integers(2, 4)),
                        num_blocks=need + 2, eos_id=int(rng.integers(0, 512)),
                        alloc=CheckedAllocator)
    assert teng.pool.alloc.trims > 0
    assert (teng.pool.alloc._refs == 0).all()
    assert (teng.pool.tables == teng.pool.trash).all()


def test_speculate_checks_match_jax(model):
    """The draft checks raise what the JAX engine raises, with its
    messages; a draft of every family the JAX package takes (an moe draft
    here) is taken by the port too."""
    jcfg, tcfg, jparams, tparams, jdc, tdc, jdraft, tdraft = model
    bad = [
        (dict(mode="continuous"), {}, "requires mode='paged'"),
        ({}, dict(vocab=jcfg.vocab + 1), "draft vocab must match"),
        ({}, dict(window=8), "rewind"),
        ({}, dict(family="ssm"), "rewind"),
    ]
    for engine_kw, draft_kw, msg in bad:
        jspec = repro.serve.SpecConfig(jdc.with_overrides(**draft_kw), jdraft,
                                       k=2)
        tspec = repro_torch.serve.SpecConfig(tdc.with_overrides(**draft_kw),
                                             tdraft, k=2)
        kw = {"mode": "paged", "capacity": 16, "max_batch": 2, **engine_kw}
        with pytest.raises(ValueError, match=msg) as jerr:
            repro.serve.ServeEngine(jcfg, jparams, speculate=jspec, **kw)
        with pytest.raises(ValueError, match=msg) as terr:
            repro_torch.serve.ServeEngine(tcfg, tparams, speculate=tspec,
                                          device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
    moe = dict(family="moe", n_experts=4, top_k=2)
    repro.serve.ServeEngine(jcfg, jparams, mode="paged", speculate=(
        repro.serve.SpecConfig(jdc.with_overrides(**moe), jdraft, k=2)))
    repro_torch.serve.ServeEngine(
        tcfg, tparams, mode="paged", device="cpu",
        speculate=repro_torch.serve.SpecConfig(tdc.with_overrides(**moe),
                                               tdraft, k=2))
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            repro_torch.serve.ServeEngine(
                tcfg, tparams, mode="paged",
                speculate=repro_torch.serve.SpecConfig(
                    tdc, tdraft, k=2))
