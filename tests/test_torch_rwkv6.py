"""The port's rwkv6 model and its continuous serving vs the JAX package's.

Reduced ``rwkv6-1.6b`` (the ssm family: RWKV-6 time-mix and channel-mix
layers, a ``{tm_shift, cm_shift, S}`` decode state per layer) at 2 and 3
layers, with JAX ``PRNGKey(0)`` weights carried over by ``params_from_jax``:

* ``time_mix`` (which runs every WKV recurrence through
  ``kernels.ops.wkv6``) and ``channel_mix`` from a nonzero state;
* ``prefill`` logits and every cache leaf, then several decode steps;
* paged mode refuses the family with the JAX engine's message, and the
  CLI serves it.

``tests/test_torch_continuous.py`` holds the continuous engine's streams and
stats to the JAX engine's for this family as for the others.

On the CPU every WKV call runs the plain version; the CUDA kernel is held
against it on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
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
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ARCH = "rwkv6-1.6b"
# f32 through 2-3 layers: the matmuls' and the WKV dot products' summation
# orders differ (XLA vs oneDNN), ~1e-7 relative per operation. The WKV state
# sums a prompt's worth of rank-1 updates (|S| up to ~40 here) and its small
# elements are differences of large terms, so each tensor is held to a
# limit relative to its own scale: max |port - JAX| <= 1e-5 of max(1,
# max |JAX|).
RTOL = 1e-5


def close(out, ref):
    """max |out - ref| over max(1, max |ref|)."""
    out = np.asarray(torch.as_tensor(out).float())
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.max(np.abs(out - ref)) / max(1.0, np.max(np.abs(ref))))


def carried(n_layers):
    jcfg = repro.configs.get(ARCH).reduced().with_overrides(
        n_layers=n_layers)
    tcfg = repro_torch.configs.get(ARCH).reduced().with_overrides(
        n_layers=n_layers)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=[2, 3], ids=["2-layers", "3-layers"])
def model(request):
    return carried(request.param)


@pytest.fixture(scope="module")
def model2():
    return carried(2)


def test_reduced_config_is_the_jax_cut():
    jcfg = repro.configs.get(ARCH).reduced()
    tcfg = repro_torch.configs.get(ARCH).reduced()
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.head_dim) == \
        (2, 256, 4, 64)
    full = repro_torch.configs.get(ARCH).config
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim,
            full.d_ff, full.vocab, full.dtype) == \
        (24, 2048, 32, 64, 7168, 65536, torch.bfloat16)


def test_time_mix_and_channel_mix_match_jax_from_a_state(model2):
    """One layer's blocks over 6 tokens, seeded with a nonzero token shift
    and WKV state, as a decode chunk would seed them."""
    jcfg, tcfg, jparams, tparams = model2
    rng = np.random.default_rng(0)
    D, H = jcfg.d_model, jcfg.n_heads
    x = rng.standard_normal((2, 6, D), dtype=np.float32)
    shift = rng.standard_normal((2, D), dtype=np.float32)
    S0 = rng.standard_normal((2, H, D // H, D // H), dtype=np.float32)
    jl = jax.tree.map(lambda t: t[1], jparams["layers"])
    tl = repro_torch.models.layer_params(tparams["layers"], 1)
    jy, jst = jax_rwkv6.time_mix(jcfg, jl["tm"], jnp.asarray(x),
                                 {"shift": jnp.asarray(shift),
                                  "S": jnp.asarray(S0)})
    ty, tst = rwkv6.time_mix(tcfg, tl["tm"], torch.from_numpy(x),
                             {"shift": torch.from_numpy(shift),
                              "S": torch.from_numpy(S0)})
    assert close(ty, jy) < RTOL
    assert close(tst["shift"], jst["shift"]) == 0.0
    assert close(tst["S"], jst["S"]) < RTOL
    jc, jshift = jax_rwkv6.channel_mix(jcfg, jl["cm"], jnp.asarray(x),
                                       jnp.asarray(shift))
    tc, tshift = rwkv6.channel_mix(tcfg, tl["cm"], torch.from_numpy(x),
                                   torch.from_numpy(shift))
    assert close(tc, jc) < RTOL and close(tshift, jshift) == 0.0


def flat_state(cache):
    return {k: cache["state"][k] for k in ("tm_shift", "cm_shift", "S")}


def test_prefill_cache_and_decode_steps_match_jax(model):
    """Prefill logits and every cache leaf (``[L, B, ...]``, S in f32),
    then four decode steps fed the JAX greedy tokens."""
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(1).integers(0, 512, size=(2, 23))
    jl, jc = jax_model.prefill(jcfg, jparams,
                                  jnp.asarray(toks, jnp.int32), 32)
    tl, tc = repro_torch.models.prefill(
        tcfg, tparams, torch.as_tensor(toks, dtype=torch.int32), 32)
    assert close(tl, jl) < RTOL
    assert tc["idx"] == int(jc["idx"]) == 23
    assert tc["state"]["S"].dtype == torch.float32
    for k, leaf in flat_state(tc).items():
        assert tuple(leaf.shape) == tuple(jc["state"][k].shape), k
        assert close(leaf, jc["state"][k]) < RTOL, k
    for _ in range(4):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = jax_model.decode_step(jcfg, jparams, jnp.asarray(tok),
                                          jc)
        tl, tc = repro_torch.models.decode_step(tcfg, tparams,
                                                torch.as_tensor(tok), tc)
        assert close(tl, jl) < RTOL
        for k, leaf in flat_state(tc).items():
            assert close(leaf, jc["state"][k]) < RTOL, k
    assert tc["idx"] == 27


def test_init_cache_matches_jax_layout(model):
    jcfg, tcfg, _, _ = model
    jc = repro.models.init_cache(jcfg, 3, 32)
    tc = repro_torch.models.init_cache(tcfg, 3, 32, device="cpu")
    for k, leaf in flat_state(tc).items():
        assert tuple(leaf.shape) == tuple(jc["state"][k].shape), k
        assert str(leaf.dtype).split(".")[-1] == str(jc["state"][k].dtype), k
        assert float(leaf.abs().max()) == 0.0
    assert tc["idx"] == 0


def test_paged_mode_refuses_the_family_with_the_jax_error(model2):
    jcfg, tcfg, jparams, tparams = model2
    msgs = []
    for eng, cfg, p, kw in ((repro.serve.ServeEngine, jcfg, jparams, {}),
                            (repro_torch.serve.ServeEngine, tcfg, tparams,
                             {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            eng(cfg, p, mode="paged", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "family='ssm'" in msgs[0]


def test_prefill_refuses_padding(model2):
    _, tcfg, _, tparams = model2
    with pytest.raises(ValueError, match="ssm family's recurrent state"):
        repro_torch.models.prefill(tcfg, tparams,
                                   torch.zeros((1, 8), dtype=torch.int32),
                                   32, length=5)


def test_cli_serves_reduced_rwkv6_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
          "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3
    assert "12 tokens" in out and "mode=continuous" in out
