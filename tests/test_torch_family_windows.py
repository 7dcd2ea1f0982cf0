"""A sliding window on the moe, vlm and audio families, against the JAX
package.

The JAX model applies ``cfg.window`` to every KV family's self-attention:
the moe and vlm layers and audio's decoder (its encoder and
cross-attention take none), in prefill and decode alike, and
``model_for_shape("long_500k")`` gives phi3.5-moe, grok-1 and chameleon-34b
``window=4096``. The port takes the window on the same families and refuses
it on the hybrid and ssm families, whose layers never read it. Paged mode
refuses a window in both packages, and so does a speculative draft.

Reduced ``phi3.5-moe-42b-a6.6b``, ``chameleon-34b`` and ``whisper-tiny``
with the window cut to 8 (f32, identical weights): 13-token prompts run
past it, so prefill attends within it and, at capacity 8, rolls the ring
(position p at slot p % 8); decode writes the ring at idx % 8. Prefill
logits, every cache leaf and three decode steps agree within ``TOL`` (the
limit of ``tests/test_torch_families.py``); the engine's streams and
counters equal the JAX engine's in continuous and cohort mode at narrow
widths.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.models  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from test_torch_families import (FAMILY_ARCH, NARROW, assert_caches_close,  # noqa: E402
                                 build, drain, extras, np32, workload)
import torch_jax_model as jax_model  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL = 1e-4
W = 8


def test_window_is_taken_where_the_jax_model_reads_it():
    for arch in ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "chameleon-34b"):
        jcfg = repro.configs.get(arch).model_for_shape("long_500k")
        tcfg = repro_torch.configs.get(arch).model_for_shape("long_500k")
        assert tcfg.window == jcfg.window == 4096
        ttf.require_ported(tcfg)
    whisper = repro_torch.configs.get("whisper-tiny").reduced()
    ttf.require_ported(whisper.with_overrides(window=W))
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b"):
        cfg = repro_torch.configs.get(arch).reduced().with_overrides(
            window=W)
        with pytest.raises(NotImplementedError, match="window"):
            ttf.require_ported(cfg)


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCH.values()))
def test_windowed_prefill_cache_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = build(arch, window=W)
    B, S = 2, 13
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jkw, tkw = extras(jcfg, B, S)
    jl, jc = jax_model.prefill(jcfg, jp, jnp.asarray(toks), W, **jkw)
    tl, tc = repro_torch.models.prefill(tcfg, tp, torch.from_numpy(toks), W,
                                        **tkw)
    assert np.abs(np32(tl) - np32(jl)).max() < TOL
    assert_caches_close(jc, tc)
    assert tuple(tc["kv"]["k"].shape)[2] == W and int(tc["idx"]) == S
    # the window bites: without it the last row's logits move
    full, _ = repro_torch.models.prefill(tcfg.with_overrides(window=None),
                                         tp, torch.from_numpy(toks), S,
                                         **tkw)
    assert np.abs(np32(full) - np32(tl)).max() > 1e-3
    for _ in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jax_model.decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tl, tc = repro_torch.models.decode_step(tcfg, tp,
                                                torch.from_numpy(tok), tc)
        assert np.abs(np32(tl) - np32(jl)).max() < TOL
        assert_caches_close(jc, tc)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_windowed_engine_streams_match_jax(family):
    """8 requests of 7 and 13 tokens, budget 6, over 4 slots of capacity
    8 (a ring of the window): continuous and cohort mode against the JAX
    engine; paged mode refuses the window with the JAX engine's
    message."""
    jcfg, tcfg, jp, tp = build(FAMILY_ARCH[family], **NARROW, window=W)
    reqs = workload(jcfg.vocab, 8, (7, 13))
    for mode in ("continuous", "cohort"):
        kw = dict(mode=mode, capacity=W, max_batch=4, decode_chunk=4)
        jeng = repro.serve.ServeEngine(jcfg, jp, **kw)
        teng = repro_torch.serve.ServeEngine(tcfg, tp, device="cpu", **kw)
        assert drain(teng, reqs) == drain(jeng, reqs)
        assert {k: teng.stats[k] for k in jeng.stats if k != "prefill_s"} \
            == {k: v for k, v in jeng.stats.items() if k != "prefill_s"}
    with pytest.raises(ValueError, match="paged mode needs") as jerr:
        repro.serve.ServeEngine(jcfg, jp, mode="paged")
    with pytest.raises(ValueError, match="paged mode needs") as terr:
        repro_torch.serve.ServeEngine(tcfg, tp, mode="paged", device="cpu")
    assert str(terr.value) == str(jerr.value)
