"""The moe, vlm and audio families in the port, against the JAX package:
``phi3.5-moe-42b-a6.6b``, ``grok-1-314b`` (logit soft-cap),
``chameleon-34b`` (early fusion of image embeddings) and ``whisper-tiny``
(LayerNorm, GELU, the encoder, cross-attention and its cache).

The registry holds all ten JAX architectures, with the JAX configs' fields
and ``param_count``. The models run cut by ``.reduced()`` (2 layers,
d_model 256, f32) on identical weights (the JAX tree carried over with
``params_from_jax``): prefill, every cache leaf and three decode steps
agree within ``TOL``, the limit ``tests/test_prefill_decode.py`` holds the
reference's own prefill and decode to. ``cache_batch_axes`` and
``cache_capacity_axes`` equal the reference's for all ten archs. The
serving engine's streams equal the JAX engine's on narrow widths: the MoE
family in the continuous, cohort and paged modes (the continuous workload
is one where a joint ``moe_mlp`` over the slots would drop a token, and the
test sees that drop, so it can tell per-slot routing from joint routing),
vlm in continuous and paged, audio in continuous and cohort.
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.weights import params_from_jax, truncate_params  # noqa: E402
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL = 1e-4
NEW_ARCHS = ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "chameleon-34b",
             "whisper-tiny")
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "qkv_bias",
              "rope_theta", "window", "n_experts", "top_k",
              "capacity_factor", "moe_groups", "block_pattern", "lru_width",
              "conv1d_width", "local_window", "is_encdec", "n_enc_layers",
              "src_len", "frontend", "n_img_tokens", "norm", "act",
              "logits_softcap")
# narrow serving widths (head dim 32, the smallest the flash kernel's
# wrapper takes); the MoE capacity factor 0.5 makes a joint moe_mlp over 8
# slot tokens share C = 4 per expert (it drops), while each slot alone
# keeps C = 4 >= K
NARROW = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=64,
              vocab=64)
FAMILY_ARCH = {"moe": "phi3.5-moe-42b-a6.6b", "vlm": "chameleon-34b",
               "audio": "whisper-tiny"}
NARROW_EXTRA = {"moe": dict(capacity_factor=0.5), "vlm": {}, "audio": {}}


def np32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def build(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced arch."""
    jcfg = repro.configs.get(arch).reduced().with_overrides(**overrides)
    tcfg = repro_torch.configs.get(arch).reduced().with_overrides(
        **overrides)
    jp = jax.tree.map(np.asarray,
                      repro.models.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), \
        params_from_jax(jp, device="cpu")


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_registry_holds_every_jax_arch_with_its_fields():
    assert set(repro_torch.configs.registry.ARCHS) == \
        set(repro.configs.registry.ARCHS)
    for arch in repro.configs.registry.ARCHS:
        jspec, tspec = repro.configs.get(arch), repro_torch.configs.get(arch)
        for jc, tc in ((jspec.config, tspec.config),
                       (jspec.reduced(), tspec.reduced())):
            for f in CFG_FIELDS:
                assert getattr(tc, f) == getattr(jc, f), (arch, f)
            for active in (False, True):
                assert tc.param_count(active) == jc.param_count(active)
        ttf.require_ported(tspec.config)
    with pytest.raises(ValueError, match="moe family needs"):
        repro_torch.models.ModelConfig(
            name="x", family="moe", n_layers=1, d_model=8, n_heads=1,
            n_kv_heads=1, d_ff=8, vocab=8)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_params_tree_matches_jax(arch):
    jcfg = repro.configs.get(arch).reduced()
    tcfg = repro_torch.configs.get(arch).reduced()
    jshapes = {k: v.shape for k, v in flat(
        repro.models.init_params(jcfg, jax.random.PRNGKey(0))).items()}
    tp = repro_torch.models.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in flat(tp).items()} == jshapes
    assert repro_torch.models.param_count(tp) == \
        repro.models.transformer.param_count(
            repro.models.init_params(jcfg, jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# prefill, cache and decode
# ---------------------------------------------------------------------------

def extras(cfg, B, S, seed=21):
    """Nonzero family extras for both packages: (JAX kwargs, port
    kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        emb = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
        pos = np.stack([rng.permutation(S)[:n] for _ in range(B)]).astype(
            np.int32)
        return ({"image_embeds": jnp.asarray(emb),
                 "image_pos": jnp.asarray(pos)},
                {"image_embeds": torch.from_numpy(emb),
                 "image_pos": torch.from_numpy(pos)})
    if cfg.family == "audio":
        src = rng.standard_normal((B, cfg.src_len, cfg.d_model)).astype(
            np.float32)
        return {"src_embeds": jnp.asarray(src)}, \
            {"src_embeds": torch.from_numpy(src)}
    return {}, {}


def assert_caches_close(jc, tc):
    jf, tf = flat(jc), flat(tc)
    assert jf.keys() == tf.keys()
    for k in jf:
        if k == "/idx":
            assert int(tf[k]) == int(jf[k])
            continue
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert np.abs(np32(tf[k]) - np32(jf[k])).max() < TOL, k


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = build(arch)
    B, S, capacity = 2, 11, 24
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jkw, tkw = extras(jcfg, B, S)
    jl, jc = jax_model.prefill(jcfg, jp, jnp.asarray(toks), capacity,
                                  **jkw)
    tl, tc = repro_torch.models.prefill(tcfg, tp, torch.from_numpy(toks),
                                        capacity, **tkw)
    assert np.abs(np32(tl) - np32(jl)).max() < TOL
    assert_caches_close(jc, tc)
    if jcfg.family == "vlm":
        # the image embeddings reach the logits
        plain, _ = repro_torch.models.prefill(tcfg, tp,
                                              torch.from_numpy(toks),
                                              capacity)
        assert np.abs(np32(plain) - np32(tl)).max() > 1e-3
    for _ in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jax_model.decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tl, tc = repro_torch.models.decode_step(tcfg, tp,
                                                torch.from_numpy(tok), tc)
        assert np.abs(np32(tl) - np32(jl)).max() < TOL
        assert_caches_close(jc, tc)
    if jcfg.family == "audio":
        # init_cache's cross k/v are the prefill's
        jinit = repro.models.init_cache(jcfg, B, capacity, params=jp,
                                        src_embeds=jkw["src_embeds"])
        tinit = repro_torch.models.init_cache(
            tcfg, B, capacity, device="cpu", params=tp,
            src_embeds=tkw["src_embeds"])
        assert_caches_close(jinit, tinit)


@pytest.mark.parametrize("arch", sorted(repro.configs.registry.ARCHS))
def test_cache_axes_match_jax(arch):
    """Found on the meta device as the reference finds them by
    ``eval_shape``; the audio family's need the parameters (its cache runs
    the encoder, whose attention goes to the plain version on meta
    tensors)."""
    jcfg = repro.configs.get(arch).reduced()
    tcfg = repro_torch.configs.get(arch).reduced()
    jp = tp = None
    if jcfg.family == "audio":
        _, _, jp, tp = build(arch)
    for capacity in (16, 48):
        for name in ("cache_batch_axes", "cache_capacity_axes"):
            want = flat(getattr(repro.models, name)(jcfg, capacity,
                                                    params=jp))
            got = flat(getattr(ttf, name)(tcfg, capacity, params=tp))
            assert got == {k: int(v) for k, v in want.items()}, (name, arch)


def test_cache_specs_match_jax():
    for arch in NEW_ARCHS:
        jcfg = repro.configs.get(arch).reduced()
        tcfg = repro_torch.configs.get(arch).reduced()
        want = flat(repro.serve.steps.cache_specs(jcfg, 3, 16))
        got = flat(repro_torch.serve.steps.cache_specs(tcfg, 3, 16))
        assert got.keys() == want.keys()
        assert int(got["/idx"]) == 15
        for k in want:
            if k != "/idx":
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == want[k].shape, k


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(FAMILY_ARCH))
def family(request):
    fam = request.param
    return (fam, *build(FAMILY_ARCH[fam], **NARROW, **NARROW_EXTRA[fam]))


def workload(vocab, n, lengths, seed=1):
    """``n`` prompts of the given lengths, in turn, each with budget 6."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=lengths[i % len(lengths)]), 6)
            for i in range(n)]


def drain(eng, reqs):
    rids = [eng.submit(p, m) for p, m in reqs]
    res = eng.run()
    return [res[r] for r in rids]


def both(model, reqs, **kw):
    _, jcfg, tcfg, jp, tp = model
    jeng = repro.serve.ServeEngine(jcfg, jp, **kw)
    teng = repro_torch.serve.ServeEngine(tcfg, tp, device="cpu", **kw)
    jout, tout = drain(jeng, reqs), drain(teng, reqs)
    assert tout == jout
    assert {k: teng.stats[k] for k in jeng.stats if k != "prefill_s"} == \
        {k: v for k, v in jeng.stats.items() if k != "prefill_s"}
    return jout


MODES = {"moe": ("continuous", "cohort", "paged"),
         "vlm": ("continuous", "paged"), "audio": ("continuous", "cohort")}


def test_engine_streams_match_jax(family, monkeypatch):
    """Every mode of the family, against the JAX engine, on 8 requests over
    4 or 8 slots. vlm prompts are longer than its 4 image tokens, so text
    is left after them."""
    fam, jcfg, tcfg, jp, tp = family
    reqs = workload(jcfg.vocab, 8, (7, 10))
    drops = {"joint": 0, "alone": 0}
    moe_mlp = tmoe.moe_mlp

    def watched(cfg, p, x, *, per_token=False):
        # each slot decode's tokens, routed alone and, for comparison,
        # jointly as one group
        if per_token and x.shape[0] > 1:
            flat_x = x.reshape(1, -1, x.shape[-1])
            drops["joint"] += int((~tmoe.route(cfg, p, flat_x)["keep"])
                                  .sum())
            drops["alone"] += int((~tmoe.route(
                cfg, p, flat_x.reshape(-1, 1, x.shape[-1]))["keep"]).sum())
        return moe_mlp(cfg, p, x, per_token=per_token)

    monkeypatch.setattr(tmoe, "moe_mlp", watched)
    for mode in MODES[fam]:
        kw = dict(mode=mode, capacity=32, max_batch=8 if fam == "moe"
                  else 4, decode_chunk=4)
        if mode == "paged":
            kw.update(block_size=4)
        both(family, reqs, **kw)
    if fam == "moe":
        assert drops["joint"] > 0 and drops["alone"] == 0, drops


def test_moe_speculative_draft_matches_jax():
    """An MoE target with its own first layer as the draft (the MoE subtree
    truncated with the rest): streams and acceptance counters equal the JAX
    engine's."""
    jcfg, tcfg, jp, tp = build(FAMILY_ARCH["moe"], **NARROW,
                               **NARROW_EXTRA["moe"])
    jd = {"embed": jp["embed"], "final_norm": jp["final_norm"],
          "layers": jax.tree.map(lambda t: t[:1], jp["layers"])}
    kw = dict(mode="paged", capacity=32, max_batch=4, decode_chunk=4,
              block_size=4)
    jeng = repro.serve.ServeEngine(jcfg, jp, speculate=repro.serve.SpecConfig(
        jcfg.with_overrides(n_layers=1), jd, k=2), **kw)
    teng = repro_torch.serve.ServeEngine(
        tcfg, tp, device="cpu", speculate=repro_torch.serve.SpecConfig(
            tcfg.with_overrides(n_layers=1), truncate_params(tp, 1), k=2),
        **kw)
    reqs = workload(jcfg.vocab, 4, (7, 10), seed=2)
    assert drain(teng, reqs) == drain(jeng, reqs)
    for k in ("spec_proposed", "spec_accepted", "draft_prefills"):
        assert teng.stats[k] == jeng.stats[k], k
    assert 0 < teng.stats["spec_accepted"] <= teng.stats["spec_proposed"]


def test_family_gates_match_jax(family):
    """Prefill buckets (dense, vlm, audio at full attention) and the draft
    families (dense, vlm, moe, audio) are the JAX engine's; paged mode
    refuses the audio family with the JAX engine's message."""
    fam, jcfg, tcfg, jp, tp = family
    for mode in ("continuous", "cohort"):
        jeng = repro.serve.ServeEngine(jcfg, jp, mode=mode,
                                       prefill_bucket=True)
        teng = repro_torch.serve.ServeEngine(tcfg, tp, mode=mode,
                                             prefill_bucket=True,
                                             device="cpu")
        assert bool(teng._bucket) == bool(jeng._bucket) == (fam != "moe")
    if fam == "audio":
        with pytest.raises(ValueError, match="paged mode needs") as jerr:
            repro.serve.ServeEngine(jcfg, jp, mode="paged")
        with pytest.raises(ValueError, match="paged mode needs") as terr:
            repro_torch.serve.ServeEngine(tcfg, tp, mode="paged",
                                          device="cpu")
        assert str(terr.value) == str(jerr.value)
        return
    dense = repro.configs.get("smollm-360m").reduced().with_overrides(
        **NARROW)
    dp = repro.models.init_params(dense, jax.random.PRNGKey(1))
    for draft_family, ok in (("hybrid", False), ("ssm", False),
                             (fam, True)):
        jdc = jcfg if draft_family == fam else dense.with_overrides(
            family=draft_family)
        tdc = tcfg if draft_family == fam else repro_torch.configs.get(
            "smollm-360m").reduced().with_overrides(**NARROW,
                                                    family=draft_family)
        kw = dict(mode="paged", capacity=32, max_batch=2)
        jspec = repro.serve.SpecConfig(jdc, jp if ok else dp, k=2)
        tspec = repro_torch.serve.SpecConfig(tdc, tp, k=2)
        if ok:
            repro.serve.ServeEngine(jcfg, jp, speculate=jspec, **kw)
            repro_torch.serve.ServeEngine(tcfg, tp, speculate=tspec,
                                          device="cpu", **kw)
            continue
        with pytest.raises(ValueError, match="rewind") as jerr:
            repro.serve.ServeEngine(jcfg, jp, speculate=jspec, **kw)
        with pytest.raises(ValueError, match="rewind") as terr:
            repro_torch.serve.ServeEngine(tcfg, tp, speculate=tspec,
                                          device="cpu", **kw)
        assert str(terr.value) == str(jerr.value)
