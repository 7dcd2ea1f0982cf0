"""The dense configs the port serves since its eighth slice, against the JAX
package: ``qwen2.5-3b`` (QKV bias), ``granite-8b``, ``minicpm-2b`` and
qwen's ``long_500k`` sliding-window variant.

The registry's ``ArchSpec`` policy fields and ``model_for_shape`` must
equal the JAX package's for every arch the port registers. The models run
cut by ``.reduced()`` (2 layers, d_model 256, f32) on identical weights:
the JAX tree from ``repro.models.init_params`` with qwen's biases set to
nonzero numpy values (the JAX initialiser zeroes them, which would hide a
missing bias), carried over with ``params_from_jax``. Prefill logits, every
cache leaf and three decode steps must agree within ``TOL``.
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
from repro_torch.weights import params_from_jax  # noqa: E402
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

# f32 through 2 layers of d_model 256: the frameworks sum each matmul's
# products in other orders (XLA's dot against oneDNN), ~1e-7 relative on
# O(1) logits and cache entries; 1e-5 leaves a decade and a half.
TOL = 1e-5
NEW_ARCHS = ("qwen2.5-3b", "granite-8b", "minicpm-2b")
SPEC_FIELDS = ("train_mode", "long_ctx", "swa_window", "notes")
CFG_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "qkv_bias",
              "rope_theta", "window", "block_pattern", "lru_width",
              "conv1d_width", "local_window", "norm", "act",
              "logits_softcap")


def dtype_name(dt):
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


def assert_configs_equal(jc, tc):
    for f in CFG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("dtype", "param_dtype"):
        assert dtype_name(getattr(tc, f)) == dtype_name(getattr(jc, f)), f


def test_arch_specs_and_model_for_shape_match_jax():
    tspecs = repro_torch.configs.all_specs()
    assert set(tspecs) <= set(repro.configs.registry.ARCHS)
    assert set(NEW_ARCHS) <= set(tspecs)
    assert repro_torch.configs.SHAPES == {
        k: repro_torch.configs.InputShape(**vars(v))
        for k, v in repro.configs.registry.SHAPES.items()}
    for arch, tspec in tspecs.items():
        jspec = repro.configs.get(arch)
        for f in SPEC_FIELDS:
            assert getattr(tspec, f) == getattr(jspec, f), (arch, f)
        assert_configs_equal(jspec.config, tspec.config)
        assert_configs_equal(jspec.reduced(), tspec.reduced())
        for shape in repro_torch.configs.SHAPES:
            if jspec.long_ctx == "skip" and shape == "long_500k":
                # whisper-tiny skips it, in both packages alike
                for spec in (jspec, tspec):
                    with pytest.raises(ValueError, match="skips long_500k"):
                        spec.model_for_shape(shape)
                continue
            assert_configs_equal(jspec.model_for_shape(shape),
                                 tspec.model_for_shape(shape))
    swa = repro_torch.configs.get("qwen2.5-3b").model_for_shape("long_500k")
    assert swa.window == 4096 and swa.qkv_bias
    assert repro_torch.configs.get("rwkv6-1.6b").model_for_shape(
        "long_500k").window is None


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_params_tree_matches_jax(arch):
    """The port's own initialiser builds the JAX tree, ``b`` leaves and
    all, in ``param_dtype``."""
    jcfg = repro.configs.get(arch).reduced()
    tcfg = repro_torch.configs.get(arch).reduced()
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(
                 repro.models.init_params(jcfg, jax.random.PRNGKey(0)))[0]}
    tp = repro_torch.models.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert tflat(tp).keys() == jflat.keys()
    assert all(tuple(v.shape) == jflat[k] for k, v in tflat(tp).items())
    assert ("['layers']['attn']['wq']['b']" in jflat) == jcfg.qkv_bias


def tflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tflat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def np32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def build(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params); a QKV bias gets
    nonzero values from a seeded numpy draw in both trees."""
    jcfg = repro.configs.get(arch).reduced().with_overrides(**overrides)
    tcfg = repro_torch.configs.get(arch).reduced().with_overrides(
        **overrides)
    jparams = jax.tree.map(np.asarray,
                           repro.models.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(3)
        for name in ("wq", "wk", "wv"):
            leaf = jparams["layers"]["attn"][name]
            leaf["b"] = (0.5 * rng.standard_normal(leaf["b"].shape)
                         ).astype(np.float32)
    tparams = params_from_jax(jparams, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jparams), tparams


def assert_caches_equal(jc, tc):
    assert int(tc["idx"]) == int(jc["idx"])
    for name in ("k", "v"):
        assert tuple(tc["kv"][name].shape) == jc["kv"][name].shape
        assert np.abs(np32(tc["kv"][name])
                      - np32(jc["kv"][name])).max() < TOL, name


def run_both(jcfg, tcfg, jparams, tparams, toks, capacity, steps=3):
    """Prefill ``toks`` in both packages, then ``steps`` greedy decode steps
    on the JAX package's tokens; the logits and every cache leaf must agree
    after the prefill and after each step (the port's decode writes its
    cache in place). Returns the port's prefill cache, cloned."""
    jl, jc = jax_model.prefill(jcfg, jparams, jnp.asarray(toks), capacity)
    tl, tc = repro_torch.models.prefill(tcfg, tparams,
                                        torch.from_numpy(toks), capacity)
    assert np.abs(np32(tl) - np32(jl)).max() < TOL
    assert_caches_equal(jc, tc)
    first = {"kv": {n: t.clone() for n, t in tc["kv"].items()},
             "idx": tc["idx"]}
    for _ in range(steps):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jax_model.decode_step(jcfg, jparams, jnp.asarray(tok), jc)
        tl, tc = repro_torch.models.decode_step(tcfg, tparams,
                                                torch.from_numpy(tok), tc)
        assert np.abs(np32(tl) - np32(jl)).max() < TOL
        assert_caches_equal(jc, tc)
    return first


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_cache_and_decode_match_jax(arch):
    jcfg, tcfg, jparams, tparams = build(arch)
    b = tparams["layers"]["attn"]["wk"].get("b")
    assert (b is not None and float(b.abs().max()) > 0) == jcfg.qkv_bias
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    run_both(jcfg, tcfg, jparams, tparams, toks, capacity=24)


def test_qwen_sliding_window_variant_matches_jax():
    """``model_for_shape("long_500k")``'s window, cut to 8 at capacity 8: a
    13-token prompt fills the ring past the window, so prefill attends
    within it and ``_kv_to_cache`` rolls the ring (position p at slot p %
    8); decode writes the ring at idx % 8."""
    spec = repro.configs.get("qwen2.5-3b")
    assert spec.model_for_shape("long_500k").window == spec.swa_window
    jcfg, tcfg, jparams, tparams = build("qwen2.5-3b", window=8)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    tc = run_both(jcfg, tcfg, jparams, tparams, toks, capacity=8)
    assert tuple(tc["kv"]["k"].shape)[2] == 8 and int(tc["idx"]) == 13
    # the ring really is rolled: slot 13 % 8 holds position 13 - 8 = 5's K,
    # which a prefill of the first 6 tokens puts at its slot 5
    _, c6 = repro_torch.models.prefill(tcfg, tparams,
                                       torch.from_numpy(toks[:, :6]), 8)
    assert np.abs(np32(c6["kv"]["k"][:, :, 5])
                  - np32(tc["kv"]["k"][:, :, 13 % 8])).max() < TOL
