"""The port's speculative-decoding pieces vs the JAX package's, on the CPU.

Window routing (``tail_targets_multi``) and the window append
(``scatter_tokens``); the dense draft path (``decode_step``, the slot
decode step, including a slot whose writes run past the cache's capacity);
the target's verify (``paged_verify_step``); and one whole
``make_spec_decode`` chunk. Both packages run the same weights
(``params_from_jax``) and the same numpy inputs in f32.

The model is ``smollm-360m`` cut by ``.reduced()`` to 4 layers with 6 query
heads over 2 KV heads (smollm's GQA ratio 3). Layers past the first are
damped by 0.3 and the draft is the target's first layer
(``truncate_params``), so the draft agrees with the target on most but not
all proposals: the acceptance counts compared below are neither 0 nor all.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro_torch.configs  # noqa: E402
from repro.kernels import paged_attention_multi_ref as jax_multi_ref  # noqa: E402
from repro.models.paged import paged_verify_step as jax_verify_step  # noqa: E402
from repro.serve.batch import init_slot_cache as jax_init_slot_cache  # noqa: E402
from repro.serve.batch import scatter_tokens as jax_scatter_tokens  # noqa: E402
from repro.serve.batch import slot_axes as jax_slot_axes  # noqa: E402
from repro.serve.batch import tail_targets_multi as jax_tail_targets_multi  # noqa: E402
from repro.serve.batch import write_slot as jax_write_slot  # noqa: E402
from repro.serve.spec import make_spec_decode as jax_make_spec_decode  # noqa: E402
from repro.serve.steps import make_slot_decode_step as jax_slot_step  # noqa: E402
from repro_torch.kernels import paged_attention_multi  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.models.paged import paged_verify_step  # noqa: E402
from repro_torch.serve.batch import (init_slot_cache, scatter_tokens,  # noqa: E402
                                     slot_axes, tail_targets,
                                     tail_targets_multi, write_slot)
from repro_torch.serve.spec import SpecConfig, make_spec_decode  # noqa: E402
from repro_torch.serve.steps import make_slot_decode_step  # noqa: E402
from repro_torch.weights import params_from_jax, truncate_params  # noqa: E402
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

OVERRIDES = dict(n_heads=6, n_kv_heads=2, head_dim=32, n_layers=4)
DAMP = 0.3
# f32 through 4 layers: the frameworks sum the matmul products in another
# order (~1e-7 relative per product) on O(1) logits and K/V; 1e-4 leaves two
# decades of room (the same limit as tests/test_torch_models.py).
TOL = 1e-4


def damped(jparams, n_layers, damp):
    """Scale every leaf of layers 1.. by ``damp`` (as the JAX serving
    benchmark builds its speculative pair): the target's early layers then
    predict its output, as a trained model's do."""
    scale = np.ones((n_layers,), np.float32)
    scale[1:] = damp
    return {**jparams, "layers": jax.tree.map(
        lambda leaf: leaf * scale.reshape((n_layers,) + (1,) * (leaf.ndim - 1))
        .astype(leaf.dtype), jparams["layers"])}


@pytest.fixture(scope="module")
def model():
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    jparams = damped(repro.models.init_params(jcfg, jax.random.PRNGKey(1)),
                     jcfg.n_layers, DAMP)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jdraft = {"embed": jparams["embed"], "final_norm": jparams["final_norm"],
              "layers": jax.tree.map(lambda leaf: leaf[:1],
                                     jparams["layers"])}
    return (jcfg, tcfg, jparams, tparams, jcfg.with_overrides(n_layers=1),
            tcfg.with_overrides(n_layers=1), jdraft,
            truncate_params(tparams, 1))


def np32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def err(a, b):
    return float(np.abs(np32(a) - np32(b)).max())


# ---------------------------------------------------------------------------
# window routing and append
# ---------------------------------------------------------------------------

ROUTING_CASES = [
    # tables, idx, live, q, block_size, trash
    ([[5, 2, 9], [7, 9, 9]], [3, 1], [True, True], 3, 4, 9),   # spans a page
    ([[3, 4], [1, 0]], [1, 3], [True, False], 4, 2, 4),         # dead, past
    ([[0, 1, 2]], [10], [True], 5, 4, 3),                       # past capacity
    ([[6, 2], [4, 5], [1, 6]], [0, 7, 2], [True, True, False], 1, 4, 6),
]


@pytest.mark.parametrize("case", range(len(ROUTING_CASES)))
def test_tail_targets_multi_matches_jax(case):
    """Each position resolves its own page; dead slots, unallocated pages
    and positions past the table go to the trash block; q = 1 is the
    single-token routing."""
    tables, idx, live, q, bs, trash = ROUTING_CASES[case]
    t = (np.asarray(tables, np.int32), np.asarray(idx, np.int32),
         np.asarray(live))
    jblk, joff = jax_tail_targets_multi(*(jnp.asarray(a) for a in t), q, bs,
                                        trash)
    blk, off = tail_targets_multi(*(torch.from_numpy(a) for a in t), q, bs,
                                  trash)
    assert blk.dtype == off.dtype == torch.int32
    assert blk.tolist() == np.asarray(jblk).tolist()
    assert off.tolist() == np.asarray(joff).tolist()
    one, one_off = tail_targets(*(torch.from_numpy(a) for a in t), bs, trash)
    assert blk[:, 0].tolist() == one.tolist()
    assert off[:, 0].tolist() == one_off.tolist()


@pytest.mark.parametrize("seed", range(3))
def test_scatter_tokens_matches_jax(seed):
    """A window append over random tables, positions and liveness: every
    block but trash equals JAX's, bit for bit (both copy the same values;
    the trash block takes colliding garbage in either order)."""
    rng = np.random.default_rng(seed)
    B, q, bs, max_blocks = 3, 5, 4, 3
    trash = B * max_blocks
    tables = np.full((B, max_blocks), trash, np.int32)
    perm = iter(rng.permutation(trash))
    for i in range(B):
        for j in range(int(rng.integers(0, max_blocks + 1))):
            tables[i, j] = next(perm)
    idx = rng.integers(0, bs * max_blocks, size=B).astype(np.int32)
    live = rng.integers(0, 2, size=B).astype(bool)
    live[0] = True
    shape = (trash + 1, bs, 2, 1, 3)                    # [N+1, bs, L, Hkv, Dh]
    pool = rng.standard_normal(shape).astype(np.float32)
    writes = rng.standard_normal((B, q) + shape[2:]).astype(np.float32)
    jblk, joff = jax_tail_targets_multi(jnp.asarray(tables), jnp.asarray(idx),
                                        jnp.asarray(live), q, bs, trash)
    want = jax_scatter_tokens({"kv": {"k": jnp.asarray(pool)}},
                              {"kv": {"k": jnp.asarray(writes)}}, jblk, joff)
    blk, off = tail_targets_multi(torch.from_numpy(tables),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(live), q, bs, trash)
    tpool = {"kv": {"k": torch.from_numpy(pool.copy())}}
    got = scatter_tokens(tpool, {"kv": {"k": torch.from_numpy(writes)}}, blk,
                         off)
    assert got is tpool     # in place
    assert np.array_equal(got["kv"]["k"][:trash].numpy(),
                          np.asarray(want["kv"]["k"])[:trash])
    # one layer through a view of the pool, as paged_verify_step writes
    want1 = jnp.asarray(pool).at[jblk, joff, 1].set(
        jnp.asarray(writes[:, :, 1]))
    tpool1 = torch.from_numpy(pool.copy())
    scatter_tokens({"kv": {"k": tpool1[:, :, 1]}},
                   {"kv": {"k": torch.from_numpy(writes[:, :, 1])}}, blk, off)
    assert np.array_equal(tpool1[:trash].numpy(), np.asarray(want1)[:trash])


# ---------------------------------------------------------------------------
# the draft: dense decode against a slot-layout cache
# ---------------------------------------------------------------------------

def prefilled(tcfg, tparams, prompts, capacity):
    """A slot-layout cache holding each prompt's prefill in its own slot."""
    cache = init_slot_cache(tcfg, len(prompts), capacity, device="cpu")
    axes = slot_axes(tcfg, capacity)
    for i, p in enumerate(prompts):
        _, req = prefill(tcfg, tparams, torch.from_numpy(p[None]), capacity)
        write_slot(cache, req, i, axes)
    return cache


def jax_cache(cache):
    return {"kv": {n: jnp.asarray(t.numpy()) for n, t in
                   cache["kv"].items()},
            "idx": jnp.asarray(np.asarray(cache["idx"]))}


def test_decode_step_matches_jax(model):
    """One token for a batch at one shared position, as the JAX package's
    ``decode_step`` takes it."""
    jcfg, tcfg, jparams, tparams = model[:4]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, size=(2, 7)).astype(np.int32)
    _, jc = jax_model.prefill(jcfg, jparams, jnp.asarray(toks), 16)
    _, tc = prefill(tcfg, tparams, torch.from_numpy(toks), 16)
    tok = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
    jl, jc = jax_model.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
    tl, tc = decode_step(tcfg, tparams, torch.from_numpy(tok), tc)
    assert tuple(tl.shape) == jl.shape == (2, 1, jcfg.vocab)
    assert err(tl, jl) < TOL and tc["idx"] == int(jc["idx"]) == 8
    for name in ("k", "v"):
        assert err(tc["kv"][name], jc["kv"][name]) < TOL


def test_slot_decode_step_matches_jax_past_capacity(model):
    """Every slot decodes at its own position. Slot 1 sits at C - 1, slot 2
    at C and slot 3 at C + 2: JAX's ``dynamic_update_slice`` clamps their
    writes to C - 1, RoPE takes the true position, and the port must do
    the same for the draft's acceptance counts to match."""
    jcfg, tcfg, jparams, tparams = model[:4]
    C = 16
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
               for n in (5, 12, 9, 14)]
    tcache = prefilled(tcfg, tparams, prompts, C)
    tcache["idx"] = torch.tensor([5, C - 1, C, C + 2], dtype=torch.int32)
    jcache = jax_cache(tcache)
    tok = rng.integers(0, jcfg.vocab, size=4).astype(np.int32)
    axes = jax_slot_axes(jcfg, C, params=jparams)
    jstep = jax_slot_step(jcfg, axes)
    tstep = make_slot_decode_step(tcfg)
    for _ in range(3):
        jtok, jcache = jstep(jparams, jnp.asarray(tok), jcache)
        ttok, tcache = tstep(tparams, torch.from_numpy(tok), tcache)
        assert ttok.tolist() == np.asarray(jtok).tolist()
        assert tcache["idx"].tolist() == np.asarray(jcache["idx"]).tolist()
        for name in ("k", "v"):
            assert err(tcache["kv"][name], jcache["kv"][name]) < TOL
        tok = np.array(jtok)
    assert tcache["idx"].tolist() == [8, C + 2, C + 3, C + 5]


def test_slot_cache_layout_matches_jax(model):
    """``init_slot_cache`` and ``write_slot`` lay a prefill into a slot as
    the JAX package's do."""
    jcfg, tcfg, jparams, tparams = model[:4]
    prompt = np.arange(3, 12, dtype=np.int32)
    _, jreq = jax_model.prefill(jcfg, jparams, jnp.asarray(prompt[None]),
                                   16)
    jc = jax_write_slot(jax_init_slot_cache(jcfg, 3, 16), jreq, 2,
                        jax_slot_axes(jcfg, 16, params=jparams))
    tc = prefilled(tcfg, tparams, [prompt, prompt[:2], prompt], 16)
    tc["kv"]["k"][:, :2] = 0
    tc["kv"]["v"][:, :2] = 0
    tc["idx"][:2] = 0
    assert tc["idx"].dtype == torch.int32
    assert tc["idx"].tolist() == np.asarray(jc["idx"]).tolist()
    for name in ("k", "v"):
        assert tuple(tc["kv"][name].shape) == jc["kv"][name].shape
        assert err(tc["kv"][name], jc["kv"][name]) < TOL


# ---------------------------------------------------------------------------
# the target: the verify window through the block table
# ---------------------------------------------------------------------------

def verify_inputs(cfg, seed, *, Q, bs=4, n_pages=4):
    """A random pool, permuted tables and four slots: a window crossing a
    page boundary, one ending on one, a dead slot, and one whose last rows
    run past the table's coverage."""
    rng = np.random.default_rng(seed)
    B, L, Hkv, Dh = 4, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    num_blocks = B * n_pages + 2
    shape = (num_blocks + 1, bs, L, Hkv, Dh)
    pk = rng.standard_normal(shape, np.float32)
    pv = rng.standard_normal(shape, np.float32)
    tables = rng.permutation(num_blocks)[:B * n_pages].reshape(
        B, n_pages).astype(np.int32)
    tables[2] = num_blocks
    idx = np.array([bs - 2, 2 * bs - Q, 0, n_pages * bs - 2], np.int32)
    live = np.array([True, True, False, True])
    toks = rng.integers(0, cfg.vocab, size=(B, Q)).astype(np.int32)
    return pk, pv, tables, idx, live, toks


@pytest.mark.parametrize("Q", [1, 4])
def test_paged_verify_step_matches_jax(model, Q):
    jcfg, tcfg, jparams, tparams = model[:4]
    pk, pv, tables, idx, live, toks = verify_inputs(jcfg, 2 + Q, Q=Q)
    trash = pk.shape[0] - 1
    pos = idx[:, None] + np.arange(Q, dtype=np.int32)
    lengths = np.where(live, idx + Q, 0).astype(np.int32)
    jblk, joff = jax_tail_targets_multi(jnp.asarray(tables), jnp.asarray(idx),
                                        jnp.asarray(live), Q, 4, trash)
    jlog, jpool = jax_verify_step(
        jcfg, jparams, jnp.asarray(toks),
        {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}, jnp.asarray(tables),
        jblk, joff, jnp.asarray(pos), jnp.asarray(lengths),
        attend=jax_multi_ref)
    blk, off = tail_targets_multi(torch.from_numpy(tables),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(live), Q, 4, trash)
    pool = {"k": torch.from_numpy(pk.copy()), "v": torch.from_numpy(pv.copy())}
    before = paged_attention_multi.launches
    tlog, tpool = paged_verify_step(
        tcfg, tparams, torch.from_numpy(toks), pool,
        torch.from_numpy(tables), blk, off, torch.from_numpy(pos),
        torch.from_numpy(lengths), attend=paged_attention_multi)
    assert paged_attention_multi.launches == before   # CPU: plain version
    assert tpool is pool and tuple(tlog.shape) == (4, Q, jcfg.vocab)
    assert err(tlog, jlog) < TOL
    for name in ("k", "v"):
        # the trash block takes colliding writes in either order
        assert err(tpool[name][:trash], np.asarray(jpool[name])[:trash]) < TOL


# ---------------------------------------------------------------------------
# one speculative chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,eos", [(3, None), (2, "stream")])
def test_spec_chunk_matches_jax(model, k, eos):
    """Two rounds of propose -> verify -> accept on prefilled slots (one
    dead, one with a budget shorter than the window): tokens, emit masks,
    carried state and the per-round proposed/accepted counts equal JAX's;
    the pool outside the trash block and the draft cache agree within
    tolerance."""
    jcfg, tcfg, jparams, tparams, jdc, tdc, jdraft, tdraft = model
    bs, C, rounds = 4, 32, 2
    rng = np.random.default_rng(k)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
               for n in (6, 9, 3, 13)]
    B, n_pages = len(prompts), C // bs
    trash = B * n_pages
    shape = (trash + 1, bs, tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim)
    pool = {"kv": {n: torch.zeros(shape) for n in ("k", "v")}}
    tables = np.arange(trash, dtype=np.int32).reshape(B, n_pages)[:, ::-1]
    tables = np.ascontiguousarray(tables)
    tok = np.zeros(B, np.int32)
    for i, p in enumerate(prompts):
        lg, req = prefill(tcfg, tparams, torch.from_numpy(p[None]), C)
        for name in ("k", "v"):
            pages = req["kv"][name][:, 0].movedim(1, 0).reshape(
                n_pages, bs, *shape[2:])
            pool["kv"][name][torch.from_numpy(tables[i]).long()] = pages
        tok[i] = int(torch.argmax(lg[0, -1]))
    dcache = prefilled(tdc, tdraft, prompts, C)
    idx = np.array([len(p) for p in prompts], np.int32)
    live = np.array([True, True, False, True])
    remaining = np.array([9, 3, 0, 7], np.int32)
    eos_id = None
    if eos == "stream":
        eos_id = int(tok[3])
    jpool = {"kv": {n: jnp.asarray(t.numpy()) for n, t in
                    pool["kv"].items()}}
    jdcache = jax_cache(dcache)
    jfn = jax_make_spec_decode(jcfg, jdc, jax_slot_axes(jdc, C,
                                                        params=jdraft),
                               bs, k, rounds, eos_id)
    jout = jfn(jparams, jdraft, jnp.asarray(tok), jpool, jnp.asarray(tables),
               jnp.asarray(idx), jnp.asarray(live), jnp.asarray(remaining),
               jdcache)
    tfn = make_spec_decode(tcfg, tdc, bs, k, rounds, eos_id)
    tout = tfn(tparams, tdraft, *(torch.from_numpy(a) for a in (tok,)),
               pool, *(torch.from_numpy(a) for a in (tables, idx, live,
                                                     remaining)), dcache)
    names = ("tok", "pool", "idx", "live", "remaining", "tokens", "emitted",
             "dcache", "proposed", "accepted")
    for i, name in enumerate(names):
        if name in ("pool", "dcache"):
            continue
        assert tout[i].tolist() == np.asarray(jout[i]).tolist(), name
    assert tuple(tout[5].shape) == (rounds * (k + 1), B)
    accepted = tout[9].sum().item()
    assert 0 < accepted < tout[8].sum().item()
    for name in ("k", "v"):
        assert err(tout[1]["kv"][name][:trash],
                   np.asarray(jout[1]["kv"][name])[:trash]) < TOL
        assert err(tout[7]["kv"][name], jout[7]["kv"][name]) < TOL


def test_spec_config_rounds_and_k():
    cfg = repro_torch.configs.get("smollm-360m").reduced()
    assert SpecConfig(cfg, None, k=3).rounds_for(8) == 2
    assert SpecConfig(cfg, None, k=3).rounds_for(1) == 1
    assert SpecConfig(cfg, None, k=2).rounds_for(8) == 3
    with pytest.raises(ValueError, match="k >= 1"):
        SpecConfig(cfg, None, k=0)


def test_truncate_params_views_the_first_layers(model):
    tparams, tdraft = model[3], model[7]
    assert tdraft["embed"] is tparams["embed"]
    assert tdraft["final_norm"] is tparams["final_norm"]
    wq = tdraft["layers"]["attn"]["wq"]["w"]
    assert wq.shape[0] == 1
    assert wq.data_ptr() == tparams["layers"]["attn"]["wq"]["w"].data_ptr()
