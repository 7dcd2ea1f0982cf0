"""The port's dense model vs the JAX package's, on identical weights.

Both packages compute with the same parameters: the JAX tree is initialised
by ``repro.models.init_params`` and carried over with
``repro_torch.weights.params_from_jax``. Inputs come from seeded numpy. The
model is ``smollm-360m`` cut by ``.reduced()`` (2 layers, d_model 256, f32)
with 6 query heads over 2 KV heads, so the GQA ratio is smollm's 3.
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
from repro.kernels import paged_attention_ref as jax_paged_attention_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.attention import sdpa as jax_sdpa  # noqa: E402
from repro.models.paged import paged_decode_step as jax_paged_decode_step  # noqa: E402
from repro.serve.batch import tail_targets as jax_tail_targets  # noqa: E402
from repro.serve.steps import make_paged_kernel_decode as jax_make_decode  # noqa: E402
from repro_torch.kernels import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.attention import sdpa  # noqa: E402
from repro_torch.models.paged import paged_decode_step  # noqa: E402
from repro_torch.serve.batch import tail_targets  # noqa: E402
from repro_torch.serve.steps import make_paged_kernel_decode  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

OVERRIDES = dict(n_heads=6, n_kv_heads=2, head_dim=32)
# f32 through 2 layers: the two frameworks sum the matmul products in a
# different order (XLA's dot vs oneDNN), ~1e-7 relative per product; the
# logits and the cached K/V are O(1), so 1e-4 leaves two decades of room.
TOL = 1e-4
# bf16 elementwise ops (norm, rope): one bf16 ulp at |x| < 8 is 2**-4.
TOL_BF16_ELEM = 2 ** -4


@pytest.fixture(scope="module")
def model():
    jcfg = repro.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    tcfg = repro_torch.configs.get("smollm-360m").reduced().with_overrides(
        **OVERRIDES)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def np32(x):
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().float().numpy()


def test_configs_agree():
    jspec = repro.configs.get("smollm-360m")
    tspec = repro_torch.configs.get("smollm-360m")
    for jc, tc in [(jspec.config, tspec.config),
                   (jspec.reduced(), tspec.reduced())]:
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "rope_theta", "norm", "act", "window"):
            assert getattr(jc, f) == getattr(tc, f), f
        assert jnp.dtype(jc.dtype).name == str(tc.dtype).split(".")[-1]
    assert tspec.config.head_dim == 64 and tspec.config.q_per_kv == 3


def test_init_params_tree_matches_jax(model):
    jcfg, tcfg, jparams, _ = model
    tp = repro_torch.models.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    tflat = dict(flat(tp))
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert v.dtype == torch.float32


def test_layer_numerics_bf16():
    """RMSNorm, RoPE and sdpa in bf16 follow the JAX order of casts."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32) * 0.1
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    got = layers.rms_norm(tx, torch.from_numpy(w))
    want = jax_layers.rms_norm(jx, jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    assert np.abs(np32(got) - np32(want)).max() <= TOL_BF16_ELEM

    pos = np.arange(3, 8)
    xr = x.reshape(2, 5, 2, 32)
    got = layers.rope(torch.from_numpy(xr).bfloat16(), torch.from_numpy(pos),
                      10_000.0)
    want = jax_layers.rope(jnp.asarray(xr, jnp.bfloat16), jnp.asarray(pos),
                           10_000.0)
    assert got.dtype == torch.bfloat16
    assert np.abs(np32(got) - np32(want)).max() <= TOL_BF16_ELEM

    q = rng.standard_normal((2, 5, 6, 16), np.float32)
    k = rng.standard_normal((2, 5, 2, 16), np.float32)
    v = rng.standard_normal((2, 5, 2, 16), np.float32)
    p = np.arange(5)
    got = sdpa(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
               q_positions=torch.from_numpy(p), k_positions=torch.from_numpy(p),
               causal=True, window=None)
    want = jax_sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    q_positions=jnp.asarray(p), k_positions=jnp.asarray(p),
                    causal=True, window=None)
    # bf16 probabilities times bf16 values, outputs |o| < 4: two bf16 ulps
    assert np.abs(np32(got) - np32(want)).max() <= 2 ** -5 * 2


@pytest.mark.parametrize("S,length", [(11, None), (16, 11), (5, None)])
def test_prefill_matches_jax(model, S, length):
    """Last-token logits and the whole cache; ``length`` right-pads the
    prompt as pow2 prefill buckets do."""
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jcfg.vocab, size=(2, S)).astype(np.int32)
    cap = 24
    jl, jc = jax_model.prefill(
        jcfg, jparams, jnp.asarray(toks), cap,
        length=None if length is None else jnp.asarray(length, jnp.int32))
    tl, tc = repro_torch.models.prefill(tcfg, tparams, torch.from_numpy(toks),
                                        cap, length=length)
    assert tuple(tl.shape) == jl.shape == (2, 1, jcfg.vocab)
    assert np.abs(np32(tl) - np32(jl)).max() < TOL
    for name in ("k", "v"):
        assert tuple(tc["kv"][name].shape) == jc["kv"][name].shape
        assert np.abs(np32(tc["kv"][name]) - np32(jc["kv"][name])).max() < TOL
    assert tc["idx"] == int(jc["idx"])
    if length is not None:
        # padding is causally masked: the unpadded prompt gives the same
        tl2, tc2 = repro_torch.models.prefill(
            tcfg, tparams, torch.from_numpy(toks[:, :length]), cap)
        assert np.abs(np32(tl2) - np32(tl)).max() < TOL
        assert np.abs(np32(tc2["kv"]["k"][:, :, :length])
                      - np32(tc["kv"]["k"][:, :, :length])).max() < TOL


def test_sdpa_query_chunking_is_exact():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((1, 9, 6, 8), (1, 9, 2, 8), (1, 9, 2, 8)))
    p = torch.arange(9)
    kw = dict(q_positions=p, k_positions=p, causal=True, window=None)
    assert torch.allclose(sdpa(q, k, v, chunk=4, **kw), sdpa(q, k, v, **kw),
                          atol=1e-6)


def decode_inputs(cfg, seed, *, B=4, bs=4, n_pages=4):
    """A random pool, permuted tables, and one slot per state: live at a
    page boundary, live mid-page, dead, live on its first page."""
    rng = np.random.default_rng(seed)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    num_blocks = B * n_pages + 2
    shape = (num_blocks + 1, bs, L, Hkv, Dh)
    pk = rng.standard_normal(shape, np.float32)
    pv = rng.standard_normal(shape, np.float32)
    order = rng.permutation(num_blocks)
    tables = order[:B * n_pages].reshape(B, n_pages).astype(np.int32)
    tables[2] = num_blocks                      # dead slot: all trash
    idx = np.array([8, 6, 0, 2], np.int32)
    live = np.array([True, True, False, True])
    tok = rng.integers(0, cfg.vocab, size=B).astype(np.int32)
    return pk, pv, tables, idx, live, tok


@pytest.mark.parametrize("attend", ["ref", "wrapper"])
def test_paged_decode_step_matches_jax(model, attend):
    jcfg, tcfg, jparams, tparams = model
    pk, pv, tables, idx, live, tok = decode_inputs(jcfg, 3)
    trash = pk.shape[0] - 1
    lengths = np.where(live, idx + 1, 0).astype(np.int32)

    jblk, joff = jax_tail_targets(jnp.asarray(tables), jnp.asarray(idx),
                                  jnp.asarray(live), 4, trash)
    jlog, jpool = jax_paged_decode_step(
        jcfg, jparams, jnp.asarray(tok), {"k": jnp.asarray(pk),
                                          "v": jnp.asarray(pv)},
        jnp.asarray(tables), jblk, joff, jnp.asarray(idx),
        jnp.asarray(lengths), attend=jax_paged_attention_ref)

    tt = torch.from_numpy(tables)
    blk, off = tail_targets(tt, torch.from_numpy(idx), torch.from_numpy(live),
                            4, trash)
    assert np.array_equal(blk.numpy(), np.asarray(jblk))
    assert np.array_equal(off.numpy(), np.asarray(joff))
    pool = {"k": torch.from_numpy(pk.copy()), "v": torch.from_numpy(pv.copy())}
    fn = paged_attention_ref if attend == "ref" else paged_attention
    tlog, tpool = paged_decode_step(
        tcfg, tparams, torch.from_numpy(tok), pool, tt, blk, off,
        torch.from_numpy(idx), torch.from_numpy(lengths), attend=fn)
    assert tpool is pool   # updated in place
    assert tuple(tlog.shape) == (4, jcfg.vocab)
    assert np.abs(np32(tlog) - np32(jlog)).max() < TOL
    for name in ("k", "v"):
        assert np.abs(np32(tpool[name]) - np32(jpool[name])).max() < TOL


def test_paged_decode_chunk_matches_jax(model):
    """Four fused steps with EOS and budget masking: tokens, emit mask and
    carried state equal JAX's, pools within tolerance."""
    jcfg, tcfg, jparams, tparams = model
    pk, pv, tables, idx, live, tok = decode_inputs(jcfg, 4)
    remaining = np.array([4, 2, 0, 4], np.int32)
    chunk, eos = 4, int(tok[3])   # slot 3 can stop on EOS
    jfn = jax_make_decode(jcfg, 4, chunk, eos)
    jout = jfn(jparams, jnp.asarray(tok),
               {"kv": {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}},
               jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(live),
               jnp.asarray(remaining))
    tfn = make_paged_kernel_decode(tcfg, 4, chunk, eos)
    tout = tfn(tparams, torch.from_numpy(tok),
               {"kv": {"k": torch.from_numpy(pk.copy()),
                       "v": torch.from_numpy(pv.copy())}},
               torch.from_numpy(tables), torch.from_numpy(idx),
               torch.from_numpy(live), torch.from_numpy(remaining))
    for k in (0, 2, 3, 4, 5, 6):   # tok idx live remaining tokens emitted
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    assert np.asarray(jout[6]).sum() > 0
    for name in ("k", "v"):
        assert np.abs(np32(tout[1]["kv"][name])
                      - np32(jout[1]["kv"][name])).max() < TOL


def test_params_from_jax_rejects_other_families():
    with pytest.raises(ValueError, match="dense"):
        params_from_jax({"embed": {}, "blocks": {}}, device="cpu")
