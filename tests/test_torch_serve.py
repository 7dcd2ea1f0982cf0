"""The port's paged serving stack vs the JAX package's.

* Host side: the block allocator, the prefix index and the slot scheduler
  are driven through the same seeded operation sequences in both packages,
  and their states are compared after every operation — they must be
  identical.
* End to end: ``repro_torch`` ``ServeEngine(mode="paged")`` on the CPU
  (paged attention through the kernel wrapper, which takes its plain version
  for CPU tensors) must produce the same greedy streams as the JAX
  ``ServeEngine(mode="paged", kv_impl="kernel")``, with the same host-side
  counters, on mixed lengths, EOS, forced preemption and shared-prefix
  workloads. Both run the same weights (``params_from_jax``) in f32, where
  the logits agree to ~1e-6 (test_torch_models.py), far below any top-2 gap
  these seeds produce.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro.serve  # noqa: E402
import repro.serve.batch as jax_batch  # noqa: E402
import repro.serve.scheduler as jax_sched  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.serve  # noqa: E402
import repro_torch.serve.batch as torch_batch  # noqa: E402
import repro_torch.serve.scheduler as torch_sched  # noqa: E402
from repro_torch.kernels import paged_attention  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

OVERRIDES = dict(n_heads=6, n_kv_heads=2, head_dim=32)


# ---------------------------------------------------------------------------
# host-side traces
# ---------------------------------------------------------------------------

def alloc_state(a):
    return (a.tables.tolist(), list(a._free), a._refs.tolist(),
            a._gens.tolist(), a._count.tolist(), a.free_blocks,
            a.high_water())


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (AssertionError, RuntimeError, ValueError) as e:
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_prefix_index_traces_identical(seed):
    """Random ensure/attach/fork/trim/release and prefix record/match
    sequences: identical return values and states after every op."""
    rng = np.random.default_rng(seed)
    kw = dict(num_blocks=10, block_size=4, max_batch=3, capacity=24)
    pair = (jax_batch.BlockAllocator(**kw), torch_batch.BlockAllocator(**kw))
    index = (jax_batch.PrefixIndex(pair[0]), torch_batch.PrefixIndex(pair[1]))
    prompts = [rng.integers(0, 5, size=int(rng.integers(1, 14)))
               for _ in range(4)]
    prompts.append(np.concatenate([prompts[0], prompts[1]]))
    for _ in range(60):
        op = rng.integers(0, 6)
        slot = int(rng.integers(0, 3))
        if op == 0:
            n = int(rng.integers(0, 26))
            res = [outcome(a.ensure, slot, n) for a in pair]
        elif op == 1:
            live = [int(b) for b in pair[0].tables[:, :2].ravel()
                    if b < kw["num_blocks"]]
            blocks = live[:int(rng.integers(0, 3))]
            res = [outcome(a.attach, slot, blocks) for a in pair]
        elif op == 2:
            page = int(rng.integers(0, 3))
            res = [outcome(a.fork_for_write, slot, page) for a in pair]
        elif op == 3:
            n = int(rng.integers(0, 12))
            res = [outcome(a.trim, slot, n) for a in pair]
        elif op == 4:
            res = [outcome(a.release, slot) for a in pair]
        else:
            p = prompts[int(rng.integers(0, len(prompts)))]
            if pair[0].owned(slot) >= -(-len(p) // 4):
                blocks = pair[0].tables[slot, :pair[0].owned(slot)]
                first = int(rng.integers(0, 9))
                for ix in index:
                    ix.record(p, blocks, first_tok=first)
            res = [ix.match(p) for ix in index]
        assert res[0] == res[1]
        assert alloc_state(pair[0]) == alloc_state(pair[1])


def test_scheduler_traces_identical():
    """submit / gated admit / preempt-youngest / record_decode / release."""
    rng = np.random.default_rng(0)
    scheds = (jax_sched.SlotScheduler(3), torch_sched.SlotScheduler(3))
    reqs = ([], [])
    for rid in range(7):
        prompt = rng.integers(0, 9, size=int(rng.integers(1, 6)))
        budget = int(rng.integers(1, 6))
        for s, mod, rl in zip(scheds, (jax_sched, torch_sched), reqs):
            r = mod.Request(rid, prompt, budget)
            rl.append(r)
            s.submit(r)

    def state(s):
        return ([None if r is None else (r.rid, list(r.output), r.done,
                                         r.admit_seq) for r in s.slots],
                [r.rid for r in s.queue], s.n_admitted, s.n_finished,
                s.n_preempted)

    for step in range(30):
        gate = bool(rng.integers(0, 4))
        admitted = [[(i, r.rid) for i, r in s.admit(lambda r: gate)]
                    for s in scheds]
        assert admitted[0] == admitted[1]
        if step % 5 == 4 and scheds[0].occupied():
            victims = [s.youngest() for s in scheds]
            assert victims[0] == victims[1]
            for s in scheds:
                s.preempt(victims[0])
        tokens = rng.integers(0, 9, size=(3, 3))
        emitted = rng.integers(0, 2, size=(3, 3)).astype(bool)
        done = [s.record_decode(tokens, emitted, eos_id=4) for s in scheds]
        assert done[0] == done[1]
        for s in scheds:
            for i in done[0]:
                s.release(i)
        assert state(scheds[0]) == state(scheds[1])
        if not scheds[0].has_work():
            break
    assert not scheds[1].has_work()


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


HOST_STATS = ("prefills", "decode_dispatches", "decode_steps",
              "emitted_tokens", "preemptions", "peak_concurrency",
              "prefix_hits", "cow_forks", "prefill_tokens",
              "peak_blocks_in_use", "peak_shared_blocks")


def drain_both(model, reqs, **kw):
    jcfg, tcfg, jparams, tparams = model
    kw = {"capacity": 48, "max_batch": 3, "decode_chunk": 4,
          "block_size": 8, **kw}
    jeng = repro.serve.ServeEngine(jcfg, jparams, mode="paged",
                                   kv_impl="kernel", **kw)
    teng = repro_torch.serve.ServeEngine(tcfg, tparams, mode="paged",
                                         device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, max_new_tokens=b) for p, b in reqs]
        res = eng.run()
        out.append([res[r] for r in rids])
        assert eng.pool.free_blocks == eng.pool.num_blocks
    assert out[1] == out[0]
    assert {k: teng.stats[k] for k in HOST_STATS} == \
        {k: jeng.stats[k] for k in HOST_STATS}
    return jeng, teng, out[1]


def test_streams_mixed_lengths(model):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, size=int(n)), int(b))
            for n, b in zip(rng.integers(3, 30, size=5), (6, 9, 1, 5, 7))]
    before = paged_attention.launches
    _, teng, streams = drain_both(model, reqs)
    assert [len(s) for s in streams] == [b for _, b in reqs]
    assert teng.kv_impl == "kernel"
    assert paged_attention.launches == before   # CPU: plain version only


def test_streams_eos(model):
    prompt = np.arange(5, 17)
    _, _, (ref,) = drain_both(model, [(prompt, 10)])
    k = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    _, _, streams = drain_both(model, [(prompt, 10), (np.arange(3, 9), 8)],
                               eos_id=ref[k])
    assert streams[0] == ref[:k + 1]


def test_streams_forced_preemption(model):
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, 512, size=int(rng.integers(6, 20))), int(b))
            for b in (12, 10, 14, 9, 11)]
    jeng, _, _ = drain_both(model, reqs, num_blocks=9, max_batch=4)
    assert jeng.stats["preemptions"] > 0, "workload must preempt"


def test_streams_shared_prefix(model):
    """A common 16-token system prompt (two full blocks) under several
    tails, and an exact resubmission admitted while the original is still
    decoding: a prefix hit that skips prefill and shares the original's
    partial tail block, which is forked on the next append."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, 512, size=16)
    a = np.concatenate([system, rng.integers(0, 512, size=5)])
    reqs = [(a, 12),
            (np.concatenate([system, rng.integers(0, 512, size=3)]), 2),
            (a, 6),
            (np.concatenate([system, rng.integers(0, 512, size=7)]), 5),
            (system[:12], 6)]
    jeng, _, _ = drain_both(model, reqs, share_prefix=True, max_batch=2)
    assert jeng.stats["prefix_hits"] > 0 and jeng.stats["cow_forks"] > 0
    assert jeng.stats["peak_shared_blocks"] > 0


def test_stream_deltas_and_unported_options(model):
    _, tcfg, _, tparams = model
    eng = repro_torch.serve.ServeEngine(tcfg, tparams, mode="paged",
                                        capacity=32, max_batch=2,
                                        device="cpu")
    rids = [eng.submit(np.arange(1, 6), 5), eng.submit(np.arange(2, 4), 3)]
    seen = {r: [] for r in rids}
    dones = set()
    for rid, delta, done in eng.stream():
        assert rid not in dones
        seen[rid] += delta
        if done:
            dones.add(rid)
    assert dones == set(rids) and [len(seen[r]) for r in rids] == [5, 3]
    with pytest.raises(ValueError, match="cache positions"):
        eng.submit(np.arange(30), 5)
    # the options ported since (tests/test_torch_serve_modes.py holds
    # them to the JAX engine) build; an unknown read path does not
    for kw, kv_impl in (({"mode": "cohort"}, None),
                        ({"kv_impl": "reference"}, "reference"),
                        ({"kv_impl": "pallas"}, "pallas")):
        other = repro_torch.serve.ServeEngine(tcfg, tparams, device="cpu",
                                              **{"mode": "paged", **kw})
        assert other.kv_impl == kv_impl
    with pytest.raises(ValueError, match="kv_impl must be"):
        repro_torch.serve.ServeEngine(tcfg, tparams, device="cpu",
                                      mode="paged", kv_impl="nope")
