"""The port's roofline (``repro_torch.launch.roofline``) and its trace
analysis (``launch/trace_analysis.py``) against the JAX package's
``launch/roofline.py`` and ``launch/hlo_analysis.py``: the same useful-work
arithmetic for all 40 (arch x shape) pairs, and the traced flops of a
reduced smollm and phi3.5-moe ``loss_fn`` against the HLO walker's dot
flops of the same function compiled on the CPU."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import SHAPES as JSHAPES, get as jget  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch.hlo_analysis import analyze as janalyze  # noqa: E402
from repro.models import init_params as jinit, loss_fn as jloss  # noqa: E402
from repro_torch import fold  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get, pairs  # noqa: E402
from repro_torch.kernels import ref, rglru_scan, wkv6_scan  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import _serve_params  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.trace_analysis import analyze, as_meta  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.train import TrainerConfig  # noqa: E402
from repro_torch.train.decentral import (make_mix,  # noqa: E402
                                         make_step_fns, node_keys_spec,
                                         state_shape, step_batch_specs)
from torch_threads import one_intra_op_thread  # noqa: E402,F401


def test_pairs_match_reference():
    from repro.configs import pairs as jpairs
    assert list(pairs(include_skips=True)) == list(
        jpairs(include_skips=True))
    assert len(list(pairs(include_skips=True))) == 40
    assert list(pairs()) == list(jpairs())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_and_useful_ratio_equal_reference(arch):
    """Every shape of the arch, at per-device flops of 1e15 on 256 and 512
    chips."""
    for name in SHAPES:
        shape, jshape = SHAPES[name], JSHAPES[name]
        for n in (256, 512):
            assert roofline.model_flops(get(arch), shape, n) == \
                jroof.model_flops(jget(arch), jshape, n)
            assert roofline.useful_ratio(get(arch), shape, 1e15, n) == \
                jroof.useful_ratio(jget(arch), jshape, 1e15, n)
    assert roofline.useful_ratio(get(arch), SHAPES["train_4k"], 0.0, 1) == 0


def test_roofline_terms_on_the_h100():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = roofline.Roofline(989e12, 3.35e12 * 2, 450e9 / 4)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 0.25)
    assert r.dominant == "memory"
    j = jroof.Roofline(989e12, 3.35e12 * 2, 450e9 / 4).as_dict()
    assert set(r.as_dict()) == set(j)


def onehot_flops(cfg, tokens: int) -> int:
    """The port's training embedding, a one-hot product (2·T·V·D), where
    the JAX forward gathers rows (no dot)."""
    return 2 * tokens * cfg.vocab * cfg.d_model


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b"])
def test_traced_flops_match_hlo_dot_flops(arch):
    """Reduced config, 4 x 64 tokens. Found: the port's count less its
    one-hot embedding product equals the HLO walker's exactly (ratio 1.0;
    with the product 1.087 for smollm, 1.049 for phi)."""
    jcfg, cfg = jget(arch).reduced(), get(arch).reduced()
    B, S = 4, 64
    p = jax.eval_shape(lambda k: jinit(jcfg, k), jax.random.PRNGKey(0))
    b = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
         for k in ("tokens", "labels")}
    hlo = jax.jit(lambda p, b: jloss(jcfg, p, b)).lower(p, b).compile()
    want = janalyze(hlo.as_text())["flops"]
    spec = dataclasses.replace(get(arch), config=cfg)
    tp, _ = _serve_params(spec, cfg, make_debug_mesh())
    tb = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
          for k in ("tokens", "labels")}
    got = analyze(lambda p, b: loss_fn(cfg, p, b), tp, tb)["flops"]
    assert want > 0
    assert abs(got - onehot_flops(cfg, B * S) - want) <= 0.01 * want


def step_args(arch, K=2, per_node=2, seq=8, algo="mdbo"):
    cfg = get(arch).reduced()
    tc = TrainerConfig(algo=algo)
    _, _, step = make_step_fns(cfg, tc)
    mix = make_mix(tc, K, device="meta")
    return ((lambda s, b, j: step(mix, s, b, j)),
            (state_shape(cfg, tc, K), step_batch_specs(cfg, tc, K, per_node,
                                                        seq),
             node_keys_spec(K)))


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b",
                                  "chameleon-34b", "whisper-tiny"])
def test_traced_flops_equal_flop_counter_mode(arch):
    """The count comes from FlopCounterMode's registry operator by
    operator; the mode itself, over the same step, agrees."""
    fn, args = step_args(arch)
    got = analyze(fn, *args)
    with FlopCounterMode(display=False) as counter:
        fn(*as_meta(args))
    assert got["flops"] == counter.get_total_flops() > 0
    assert got["traffic_bytes"] > got["argument_bytes"] > 0
    assert got["peak_bytes"] >= got["argument_bytes"] + got["output_bytes"]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_folded_scans_give_the_full_trace(arch):
    """A step of 8 tokens traced with every scan run to the end, against
    its two folded traces (2 and 3 steps) extrapolated to 8: flops equal,
    traffic within 1e-4 and the peak within 5 % (found: 0 and -1.1e-5 /
    -2.9 % for rwkv6; 0, 0 and -0.08 % for recurrentgemma)."""
    fn, args = step_args(arch)
    full = analyze(fn, *args)
    folded = analyze(fn, *args, scan_len=8)
    assert folded["flops"] == full["flops"]
    assert abs(folded["traffic_bytes"] - full["traffic_bytes"]) <= \
        1e-4 * full["traffic_bytes"]
    assert abs(folded["peak_bytes"] - full["peak_bytes"]) <= \
        0.05 * full["peak_bytes"]
    assert folded["argument_bytes"] == full["argument_bytes"]


def _scan_inputs(kind, device):
    g = torch.Generator().manual_seed(3)
    if kind == "rglru":
        a = torch.rand((2, 8, 16), generator=g)
        x = torch.randn((2, 8, 16), generator=g)
        return (rglru_scan, ref.rglru_ref, fold.rglru,
                tuple(t.to(device) for t in (a, x)))
    r, k, v = (torch.randn((2, 8, 1, 64), generator=g) for _ in range(3))
    w = torch.rand((2, 8, 1, 64), generator=g)
    u = torch.randn((1, 64), generator=g)
    s0 = torch.randn((2, 1, 64, 64), generator=g)
    return (wkv6_scan, ref.wkv6_scan_ref, fold.wkv6_scan,
            tuple(t.to(device) for t in (r, k, v, w, u, s0)))


@pytest.mark.parametrize("kind", ["rglru", "wkv6"])
def test_folded_plain_versions(kind):
    """The kernel wrappers' meta branch: ``fold``'s copies of the plain
    versions equal the references bit for bit outside a fold, keep the
    first m steps and repeat the last inside one, and the wrapper's
    folded trace on meta tensors extrapolates to its full trace (flops
    and traffic equal)."""
    _, plain, folded, args = _scan_inputs(kind, "cpu")
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    got = folded(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with fold.folded(2):
        cut = folded(*args)
    cut = cut[0] if isinstance(cut, tuple) else cut
    assert torch.equal(cut[:, :2], want[0][:, :2])
    assert torch.equal(cut[:, 2:], cut[:, 1:2].expand_as(cut[:, 2:]))

    wrapper, _, _, args = _scan_inputs(kind, "meta")
    full = analyze(wrapper, *args)
    extrapolated = analyze(wrapper, *args, scan_len=8)
    assert full["flops"] == extrapolated["flops"]
    assert full["traffic_bytes"] == extrapolated["traffic_bytes"] > 0
    assert full["output_bytes"] == extrapolated["output_bytes"]


def test_traffic_model():
    """Each operator's inputs and outputs; a view moves nothing; a copy its
    result once; an in-place index update its update."""
    a = torch.empty((4, 8), device="meta")
    idx = torch.empty((2,), dtype=torch.int64, device="meta")
    assert analyze(lambda x: x + x, a)["traffic_bytes"] == 3 * 128
    # the reshape of a transposed view copies it whole
    assert analyze(lambda x: x.t().reshape(-1)[:4].view(2, 2),
                   a)["traffic_bytes"] == 128
    assert analyze(lambda x: x.t()[:2].unsqueeze(0), a)["traffic_bytes"] == 0
    assert analyze(lambda x: x.clone(), a)["traffic_bytes"] == 128
    upd = torch.empty((2, 8), device="meta")
    assert analyze(lambda x, i, u: x.index_put_((i,), u), a, idx,
                   upd)["traffic_bytes"] == 64
    got = analyze(lambda x: (x @ x.t()).sum(), a)
    assert got["flops"] == 2 * 4 * 4 * 8
    assert got["peak_bytes"] == 128 + 64 + 4
    assert got["ops"] == 3
