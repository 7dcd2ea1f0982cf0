"""The port's hybrid (RecurrentGemma) model vs the JAX package's, on
identical weights, and smollm's prefill through the kernels' dispatch.

The JAX tree is initialised by ``repro.models.init_params`` and carried
over with ``repro_torch.weights.params_from_jax``; tokens come from seeded
numpy. The model is ``recurrentgemma-2b`` cut by ``.reduced()`` (one block
of the ("rec", "rec", "attn") pattern, d_model 256, 4 query heads over one
KV head, Dh 64, local window 64, f32), and the same cut at 5 layers, which
adds the trailing ``rem`` layers the full model has (26 = 8 x 3 + 2).
Prompts run past the window, so the window mask bites and the ring of
``_kv_to_cache`` is rolled.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.models  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.models  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models.layers import mlp as jax_mlp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, rglru  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ARCH = "recurrentgemma-2b"
# f32 through 3-5 layers: the two frameworks sum the matmul products in a
# different order (XLA's dot vs oneDNN), ~1e-7 relative per product; the
# logits, the cached K/V and the recurrent state are O(1), so 1e-4 leaves
# two decades of room.
TOL = 1e-4


def build(n_layers=None, seed=0):
    jcfg = repro.configs.get(ARCH).reduced()
    tcfg = repro_torch.configs.get(ARCH).reduced()
    if n_layers is not None:
        jcfg = jcfg.with_overrides(n_layers=n_layers)
        tcfg = tcfg.with_overrides(n_layers=n_layers)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=[None, 5], ids=["3layers", "5layers"])
def model(request):
    return build(request.param)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def tflat(tree):
    return {k: np.asarray(torch.as_tensor(v).float()) for k, v in flat(tree)}


def test_configs_agree():
    jspec, tspec = repro.configs.get(ARCH), repro_torch.configs.get(ARCH)
    for jc, tc in [(jspec.config, tspec.config),
                   (jspec.reduced(), tspec.reduced())]:
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "rope_theta", "norm", "act",
                  "window", "block_pattern", "lru_width", "conv1d_width",
                  "local_window"):
            assert getattr(jc, f) == getattr(tc, f), f
        for f in ("dtype", "param_dtype"):
            assert jnp.dtype(getattr(jc, f)).name == \
                str(getattr(tc, f)).split(".")[-1], f
    full = tspec.config
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.local_window) == (26, 2560, 10, 1, 256, 2048)
    # the default block pattern, as the JAX package's __post_init__ sets it
    bare = full.with_overrides(block_pattern=())
    assert bare.block_pattern == ("rec", "rec", "attn")


def test_init_params_tree_matches_jax(model):
    jcfg, tcfg, jparams, _ = model
    tp = repro_torch.models.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = {k: v.shape for k, v in jflat(jparams).items()}
    tshapes = {k: tuple(v.shape) for k, v in flat(tp)}
    assert tshapes == jshapes


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ours = layers.gelu(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert float(np.max(np.abs(ours - theirs))) < 1e-6
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.max(np.abs(exact - theirs))) > 1e-4


def test_gelu_mlp_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, tcfg.d_model), dtype=np.float32)
    lp = jax.tree.map(lambda t: t[0], jparams["blocks"]["l0_rec"])["mlp"]
    tlp = repro_torch.models.layer_params(tparams["blocks"]["l0_rec"], 0)
    assert "wg" not in tlp["mlp"]
    ours = layers.mlp(tcfg, tlp["mlp"], torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax_mlp(jcfg, lp, jnp.asarray(x)))
    assert float(np.max(np.abs(ours - theirs))) < TOL


def test_recurrent_block_and_step_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["l1_rec"])["rec"]
    tp = repro_torch.models.layer_params(tparams["blocks"]["l1_rec"],
                                         0)["rec"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 70, tcfg.d_model), dtype=np.float32)
    jy, jh = jax_rglru.recurrent_block(jcfg, jp, jnp.asarray(x))
    ty, th = rglru.recurrent_block(tcfg, tp, torch.from_numpy(x))
    assert float(np.max(np.abs(ty.numpy() - np.asarray(jy)))) < TOL
    assert float(np.max(np.abs(th.numpy() - np.asarray(jh)))) < TOL
    jst = jax_rglru.init_recurrent_state(jcfg, 2)
    tst = rglru.init_recurrent_state(tcfg, 2, device="cpu")
    for t in range(6):
        xt = x[:, t:t + 1]
        jy, jst = jax_rglru.recurrent_block_step(jcfg, jp, jnp.asarray(xt),
                                                 jst)
        ty, tst = rglru.recurrent_block_step(tcfg, tp, torch.from_numpy(xt),
                                             tst)
        assert float(np.max(np.abs(ty.numpy() - np.asarray(jy)))) < TOL
        for k in ("h", "conv"):
            assert float(np.max(np.abs(tst[k].numpy()
                                       - np.asarray(jst[k])))) < TOL


@pytest.mark.parametrize("S,capacity", [
    (90, 48),    # ring of the capacity, prompt past it: rolled
    (90, 96),    # ring of the local window (64), prompt past it: rolled
    (40, 96),    # prompt inside the window: zero-padded ring
    (128, 64),   # a whole number of rings: roll by 0
])
def test_prefill_and_decode_match_jax(model, S, capacity):
    """Prefill logits and every cache leaf, then 5 decode steps, each
    step's logits and every cache leaf."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(S + capacity)
    toks = rng.integers(0, tcfg.vocab, size=(1, S)).astype(np.int32)
    jl, jc = repro.models.prefill(jcfg, jparams, jnp.asarray(toks), capacity)
    tl, tc = repro_torch.models.prefill(tcfg, tparams, torch.as_tensor(toks),
                                        capacity)
    assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) < TOL
    jf, tf = jflat(jc), tflat(tc)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        assert float(np.max(np.abs(tf[k] - jf[k]))) < TOL, k
    for t in range(5):
        tok = rng.integers(0, tcfg.vocab, size=(1, 1)).astype(np.int32)
        jl, jc = repro.models.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = repro_torch.models.decode_step(tcfg, tparams,
                                                torch.as_tensor(tok), tc)
        assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) < TOL
        jf, tf = jflat(jc), tflat(tc)
        for k in jf:
            assert float(np.max(np.abs(tf[k] - jf[k]))) < TOL, (t, k)


def test_init_cache_layout_matches_jax(model):
    jcfg, tcfg, _, _ = model
    for capacity in (32, 96):
        jc = jflat(repro.models.init_cache(jcfg, 3, capacity))
        tc = tflat(repro_torch.models.init_cache(tcfg, 3, capacity,
                                                 device="cpu"))
        assert {k: v.shape for k, v in tc.items()} == \
            {k: v.shape for k, v in jc.items()}
        assert all(not v.any() for v in tc.values())


def test_prefill_length_is_refused_for_hybrid(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError, match="recurrent state"):
        repro_torch.models.prefill(tcfg, tparams,
                                   torch.zeros((1, 8), dtype=torch.int32), 16,
                                   length=5)


def counting(fn, calls):
    def wrapped(*args, **kw):
        calls.append(kw)
        return fn(*args, **kw)
    return wrapped


def test_kernel_dispatch_counts_per_prefill():
    """One attention call per attention layer and one recurrence per
    recurrent layer: the full model's 8 and 18 (26 layers: 8 blocks and 2
    trailing recurrent layers), here 1 and 4 (5 layers: one block and the
    same 2 trailing layers)."""
    _, tcfg, _, tparams = build(5)
    attn, scans = [], []
    repro_torch.models.prefill(tcfg, tparams,
                               torch.arange(70, dtype=torch.int32)[None], 96,
                               attend=counting(ops.attention, attn),
                               scan=counting(ops.rglru, scans))
    assert len(attn) == 1 and len(scans) == 4
    assert all(kw == {"causal": True, "window": 64} for kw in attn)


def test_smollm_prefill_through_ops_matches_jax():
    """smollm-360m's prefill routes its attention through ``ops.attention``
    (one causal, unwindowed call per layer) and still matches the JAX
    prefill, which runs the einsum ``sdpa``."""
    over = dict(n_heads=6, n_kv_heads=2, head_dim=32)
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(**over)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **over)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    toks = np.random.default_rng(3).integers(0, 512, size=(2, 45))
    calls = []
    tl, tc = repro_torch.models.prefill(
        tcfg, tparams, torch.as_tensor(toks, dtype=torch.int32), 64,
        attend=counting(ops.attention, calls))
    jl, jc = repro.models.prefill(jcfg, jparams,
                                  jnp.asarray(toks, jnp.int32), 64)
    assert calls == [{"causal": True, "window": None}] * tcfg.n_layers
    assert float(np.max(np.abs(tl.numpy() - np.asarray(jl)))) < TOL
    for name in ("k", "v"):
        assert float(np.max(np.abs(tc["kv"][name].numpy()
                                   - np.asarray(jc["kv"][name])))) < TOL
