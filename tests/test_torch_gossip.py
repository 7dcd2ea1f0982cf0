"""The port's gossip primitives against the JAX package's: the bf16
arithmetic of ``core/tracking.py`` and ``core/estimators.py``,
``core/compression.py`` and ``core/async_gossip.py``.

* bf16 trees (f32 draws cast to bf16): the mixes, the tracking and
  parameter updates and the three estimators equal the JAX package's bit
  for bit, since each coefficient meets a bf16 leaf as JAX's weakly typed
  scalar does and the dense contraction runs in f32.
* f32 trees: the compression primitives within TOL (one contraction's
  rounding, summed in another order by another library); top-k, its ties
  and the EF21 rule exactly; bf16 bit for bit.
* ``AsyncGossipMix.apply`` over several calls, the mixed output, both
  caches and both ages, under ``(K, 2)`` drop patterns of 0s and 1s, which
  make every delivery certain in both packages (their draws differ:
  threefry keys there, host numpy streams here).
* Laws where the packages' draws cannot agree: the random mask's kept
  fraction within 5 binomial standard deviations, the same mask on every
  call, other masks for other leaves; and the realized mean age of the
  host delivery streams at τ 3, drop 0.3 within 0.03 of the chain's
  stationary mean (12 800 ages: about four standard errors).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.async_gossip as rasync  # noqa: E402
import repro.core.compression as rcomp  # noqa: E402
import repro.core.estimators as rest  # noqa: E402
import repro.core.tracking as rtrack  # noqa: E402
import repro_torch.core.async_gossip as pasync  # noqa: E402
import repro_torch.core.compression as pcomp  # noqa: E402
import repro_torch.core.estimators as pest  # noqa: E402
import repro_torch.core.tracking as ptrack  # noqa: E402
from repro.core import ring as rring  # noqa: E402
from repro.core import star as rstar  # noqa: E402
from repro.core import topology as rtopo  # noqa: E402
from repro_torch.core import engine as pengine  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL = 2e-6
BF16 = (jnp.bfloat16, torch.bfloat16)
F32 = (jnp.float32, torch.float32)


def tree(K, seed=0, width=64):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(K, width, 3)).astype(np.float32),
            "b": [rng.normal(size=(K, 5)).astype(np.float32)]}


def both(t, dtypes):
    """(JAX tree, torch tree) of the same numbers in the given dtype."""
    jdt, tdt = dtypes
    return (jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(tdt), t))


def as_np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t).astype(jnp.float32))


def assert_trees(p, r, tol=0.0):
    pl, rl = jax.tree.leaves(p), jax.tree.leaves(r)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        assert tuple(a.shape) == tuple(b.shape)
        if tol == 0.0:
            np.testing.assert_array_equal(as_np(a), as_np(b))
        else:
            np.testing.assert_allclose(as_np(a), as_np(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# queue 3 fault 5: the gossip arithmetic on bf16 leaves
# ---------------------------------------------------------------------------

def _bf16_cases():
    W = rring(5).weights

    def dense(m):
        return m.dense_mix(W, "cpu") if m is ptrack else m.dense_mix(W)

    return {
        "dense_mix": lambda m, e, a, b, c: dense(m)(a),
        "ring_mix_rolled": lambda m, e, a, b, c: m.ring_mix_rolled()(a),
        "track_update": lambda m, e, a, b, c: m.track_update(a, b, c,
                                                             dense(m)),
        "param_update": lambda m, e, a, b, c: m.param_update(
            a, b, 0.1, 0.5, lambda t: t),
        "param_update_ring": lambda m, e, a, b, c: m.param_update(
            a, b, 0.1, 0.5, m.ring_mix_rolled()),
        "gossip_param_update": lambda m, e, a, b, c: m.gossip_param_update(
            a, b, 0.3, dense(m)),
        "momentum_update": lambda m, e, a, b, c: e.momentum_update(a, b, 0.3),
        "storm_update": lambda m, e, a, b, c: e.storm_update(a, b, c, 0.05),
        "sgd_update": lambda m, e, a, b, c: e.sgd_update(a, b, 0.3),
    }


@pytest.mark.parametrize("name", list(_bf16_cases()))
def test_bf16_gossip_arithmetic_equals_reference_bit_for_bit(name):
    """ROADMAP queue 3 fault 5: on bf16 trees every mix, update and
    estimator equals the JAX package's bit for bit (before the repair,
    6 770 of 20 480 ``dense_mix`` outputs differed on such a tree)."""
    fn = _bf16_cases()[name]
    (ja, ta), (jb, tb), (jc, tc) = (both(tree(5, s, 1024), BF16)
                                    for s in (0, 1, 2))
    want = fn(rtrack, rest, ja, jb, jc)
    got = fn(ptrack, pest, ta, tb, tc)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(got))
    assert_trees(got, want)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_path_seed_is_the_reference_digest():
    """Each leaf's path prints as in the JAX package and digests alike
    (torch flattens a dict in insertion order, JAX in key order)."""
    t = tree(2)
    want = {jax.tree_util.keystr(p): rcomp._path_seed(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(t)[0]}
    got = {torch.utils._pytree.keystr(p): pcomp.path_seed(p)
           for p, _ in torch.utils._pytree.tree_flatten_with_path(t)[0]}
    assert got == want and set(got) == {"['w']", "['b'][0]"}
    assert pcomp.path_seed(()) == rcomp._path_seed(())


@pytest.mark.parametrize("dtypes", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ratio", [0.05, 0.25, 1.0])
def test_topk_matches_reference(dtypes, ratio):
    jt, pt = both(tree(4, 3), dtypes)
    assert_trees(pcomp.topk_sparsify(ratio)(pt),
                 rcomp.topk_sparsify(ratio)(jt))


def test_topk_keeps_every_tie():
    """The threshold is the k-th largest magnitude, so every entry tied with
    it stays (more than k kept), as in the JAX package; a tie at a negative
    sign counts by magnitude."""
    a = np.array([[1.0, -3.0, 3.0, 0.5, 3.0, 2.0, -0.5, 0.0],
                  [2.0, 2.0, 2.0, 2.0, -2.0, 1.0, 0.0, 1.0]], np.float32)
    jt, pt = both({"a": a}, F32)
    got = pcomp.topk_sparsify(0.25)(pt)["a"]
    assert_trees(got, rcomp.topk_sparsify(0.25)(jt)["a"])
    assert got.tolist() == [[0.0, -3.0, 3.0, 0.0, 3.0, 0.0, 0.0, 0.0],
                            [2.0, 2.0, 2.0, 2.0, -2.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("dtypes,tol", [(F32, TOL), (BF16, 0.0)],
                         ids=["f32", "bf16"])
def test_compressed_mix_wmi_and_ef21_match_reference(dtypes, tol):
    K = 5
    W = rtopo.erdos_renyi(K, 0.6, 1).weights
    (ja, ta), (jh, th) = both(tree(K, 4), dtypes), both(tree(K, 5), dtypes)
    for ratio in (0.25, 1.0):
        assert_trees(
            pcomp.compressed_mix(W, pcomp.topk_sparsify(ratio), "cpu")(ta),
            rcomp.compressed_mix(W, rcomp.topk_sparsify(ratio))(ja), tol)
        assert_trees(pcomp.ef21_update(th, ta, pcomp.topk_sparsify(ratio)),
                     rcomp.ef21_update(jh, ja, rcomp.topk_sparsify(ratio)))
    got = pcomp.dense_wmi(W, "cpu")(th)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(got))
    assert_trees(got, rcomp.dense_wmi(W)(jh), tol)
    for sw in (1.0 / 3.0, 0.5):
        assert_trees(pcomp.ring_wmi_rolled(sw)(th),
                     rcomp.ring_wmi_rolled(sw)(jh))


@pytest.mark.parametrize("dtypes,tol", [(F32, TOL), (BF16, 0.0)],
                         ids=["f32", "bf16"])
def test_error_feedback_mix_over_several_calls(dtypes, tol):
    """apply, the stateless ``__call__`` (h ≡ 0: plain compressed gossip)
    and ``bind`` over two sites and three steps, accumulators included."""
    K, W = 4, rring(4).weights
    rmix = rcomp.ErrorFeedbackMix(W, rcomp.topk_sparsify(0.25))
    pmix = pcomp.ErrorFeedbackMix(W, pcomp.topk_sparsify(0.25),
                                  device="cpu")
    ja, ta = both(tree(K, 6), dtypes)
    assert_trees(pmix(ta), rmix(ja), tol)
    assert_trees(pmix(ta), pcomp.compressed_mix(
        W, pcomp.topk_sparsify(0.25), "cpu")(ta))
    sites = [both(tree(K, 7), dtypes), both(tree(K, 8, 16), dtypes)]
    rst = [rmix.state0(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), j), i)
        for i, (j, _) in enumerate(sites)]
    pst = [pmix.state0(tree_meta(p), i) for i, (_, p) in enumerate(sites)]
    assert_trees(pst, rst)
    for step in range(3):
        rfn, rout = rmix.bind(rst)
        pfn, pout = pmix.bind(pst)
        for s, (j, p) in enumerate(sites):
            jin = jax.tree.map(lambda a: a * (1 + step), j)
            pin = jax.tree.map(lambda a: a * (1 + step), p)
            assert_trees(pfn(pin), rfn(jin), tol)
        rst, pst = rout, pout
        assert_trees(pst, rst, tol)


def tree_meta(t):
    return jax.tree.map(lambda a: torch.empty_like(a, device="meta"), t)


def test_comm_bytes_and_neighbor_degree_match_exactly():
    jt, pt = both(tree(4, 9), F32)
    _, pb = both(tree(4, 9), BF16)
    jb16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jt)
    for W in (None, rring(4).weights, rstar(4).weights,
              rtopo.complete(4).weights):
        if W is not None:
            assert pcomp.neighbor_degree(W) == rcomp.neighbor_degree(W)
        for ratio in (0.05, 0.25, 1.0):
            assert (pcomp.comm_bytes_per_mix(pt, ratio, W)
                    == rcomp.comm_bytes_per_mix(jt, ratio, W))
            assert (pcomp.comm_bytes_per_mix(pb, ratio, W)
                    == rcomp.comm_bytes_per_mix(jb16, ratio, W))


def test_random_sparsify_laws():
    """Kept fraction within 5 binomial standard deviations of the ratio;
    the same mask on every call; another mask for another leaf (or seed);
    the 1/ratio rescale, and a contractive mask-only form."""
    ratio, K = 0.25, 4
    t = {"w": torch.randn(K, 500, generator=torch.Generator().manual_seed(0)),
         "v": torch.randn(K, 500, generator=torch.Generator().manual_seed(1))}
    comp = pcomp.random_sparsify(ratio, seed=3)
    out = comp(t)
    n = t["w"].numel()
    for k in ("w", "v"):
        kept = float((out[k] != 0).float().mean())
        assert abs(kept - ratio) < 5 * np.sqrt(ratio * (1 - ratio) / n)
        kept_at = out[k] != 0
        torch.testing.assert_close(out[k][kept_at], t[k][kept_at] / ratio,
                                   rtol=0, atol=0)
    again = comp({k: 2 * v for k, v in t.items()})
    assert all(torch.equal(again[k] != 0, out[k] != 0) for k in t)
    assert not torch.equal(out["w"] != 0, out["v"] != 0)
    other = pcomp.random_sparsify(ratio, seed=4)(t)
    assert not torch.equal(other["w"] != 0, out["w"] != 0)
    fresh = pcomp.random_sparsify(ratio, seed=3)(t)
    assert all(torch.equal(fresh[k], out[k]) for k in t)
    plain = pcomp.random_sparsify(ratio, seed=3, rescale=False)(t)
    for k in t:
        assert torch.equal(plain[k] != 0, out[k] != 0)
        assert float((t[k] - plain[k]).norm()) <= float(t[k].norm())
    assert all(torch.equal(pcomp.random_sparsify(1.0)(t)[k], t[k])
               for k in t)
    with pytest.raises(ValueError, match="keep ratio"):
        pcomp.random_sparsify(0.0)
    with pytest.raises(ValueError, match="keep ratio"):
        pcomp.topk_sparsify(1.5)


# ---------------------------------------------------------------------------
# async gossip
# ---------------------------------------------------------------------------

def drop_pattern(K, seed):
    """A (K, 2) drop pattern of 0s and 1s: every delivery is certain."""
    return np.random.default_rng(seed).integers(0, 2, (K, 2)).astype(
        np.float32)


@pytest.mark.parametrize("compressed", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("tau", [0, 1, 3])
def test_async_apply_matches_reference_over_several_calls(tau, compressed):
    K = 5
    drop = drop_pattern(K, tau)
    kw = dict(tau=tau, drop_prob=drop)
    rmix = rasync.AsyncGossipMix(
        K, compressor=rcomp.topk_sparsify(0.25) if compressed else None, **kw)
    pmix = pasync.AsyncGossipMix(
        K, compressor=pcomp.topk_sparsify(0.25) if compressed else None,
        device="cpu", **kw)
    ja, ta = both(tree(K, 10), F32)
    assert_trees(pmix(ta), rmix(ja), TOL)
    rst = rmix.state0(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ja), 0)
    pst = pmix.state0(tree_meta(ta), 0)
    draws = pmix.draws(1)
    for step in range(5):
        ja, ta = both(tree(K, 11 + step), F32)
        rout, rst = rmix.apply(ja, rst)
        pout, pst = pmix.apply(ta, pst, draws()[0])
        assert_trees(pout, rout, TOL)
        for k in ("h_left", "h_right"):
            assert_trees(pst[k], rst[k], TOL)
        for k in ("age_left", "age_right"):
            assert pst[k].dtype == torch.int32
            np.testing.assert_array_equal(pst[k].numpy(), np.asarray(rst[k]))
            assert int(pst[k].max()) <= tau


def test_async_draws_are_per_site_streams_and_follow_the_drop_model():
    pmix = pasync.AsyncGossipMix(4, tau=2, drop_prob=0.3, seed=1,
                                 device="cpu")
    a, b = pmix.draws(3), pmix.draws(3)
    first = a()
    assert first.shape == (3, 4, 2) and first.dtype == torch.bool
    assert torch.equal(first, b())                 # a run restarts them
    assert not torch.equal(first[0], first[1])     # sites differ
    land = torch.stack([a() for _ in range(400)]).float().mean()
    assert abs(float(land) - 0.7) < 0.02           # 9 600 draws
    assert torch.equal(pasync.AsyncGossipMix(
        4, drop_prob=1.0, device="cpu").draws(1)(), torch.zeros(1, 4, 2,
                                                                dtype=bool))


def test_realized_staleness_matches_the_stationary_chain():
    """τ 3, drop 0.3: the ages of 2 sites × 8 nodes × 2 edges over 400
    calls (after 10 to forget the forced first refresh), 12 800 ages,
    against ``expected_staleness`` (0.395). The ages' variance is 0.48, so
    the mean's standard error is ~0.006 (~0.008 allowing for the
    correlation of one edge's ages between calls); the bound 0.03 is
    nearly four of them."""
    tau, K = 3, 8
    mix = pasync.AsyncGossipMix(K, tau=tau, drop_prob=0.3, seed=0,
                                device="cpu")
    t = {"w": torch.zeros(K, 2)}
    sts = [mix.state0(tree_meta(t), i) for i in range(2)]
    draws, ages = mix.draws(2), []
    for call in range(410):
        fn, sts = mix.bind(sts, draws())
        fn(t)
        fn(t)
        if call >= 10:
            ages += [s[k] for s in sts for k in ("age_left", "age_right")]
    realized = float(torch.cat(ages).float().mean())
    expected = pasync.expected_staleness(tau, 0.3)
    assert abs(realized - expected) < 0.03
    assert expected == rasync.expected_staleness(tau, 0.3)
    for tau_, q in ((0, 0.9), (5, 0.0), (2, 0.5), (4, 1.0)):
        assert (pasync.expected_staleness(tau_, q)
                == rasync.expected_staleness(tau_, q))


def test_async_tau0_is_ring_gossip_bit_for_bit():
    K = 6
    mix = pasync.AsyncGossipMix(K, tau=0, drop_prob=0.7, device="cpu")
    t = {"w": torch.randn(K, 7, generator=torch.Generator().manual_seed(2))}
    st = mix.state0(tree_meta(t), 0)
    out, _ = mix.apply(t, st, mix.draws(1)()[0])
    assert torch.equal(out["w"], ptrack.ring_mix_rolled()(t)["w"])
    assert torch.equal(mix(t)["w"], ptrack.ring_mix_rolled()(t)["w"])


def test_reference_errors():
    with pytest.raises(ValueError, match="K>=3"):
        pasync.AsyncGossipMix(2, device="cpu")
    with pytest.raises(ValueError, match="tau"):
        pasync.AsyncGossipMix(4, tau=-1, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        pasync.AsyncGossipMix(4, local=True, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        pengine.make_mix("async_gossip", weights=rstar(5).weights, K=5,
                         device="cpu")
    with pytest.raises(ValueError, match="needs `K`"):
        pengine.make_mix("async_gossip", device="cpu")
    with pytest.raises(ValueError, match="compressed mix needs"):
        pengine.make_mix("compressed_topk", device="cpu")
    with pytest.raises(ValueError, match="W or an explicit wmi"):
        pcomp.ErrorFeedbackMix(None, pcomp.topk_sparsify(0.5), device="cpu")
    pengine.make_mix("async_gossip", weights=rring(5).weights, K=5,
                     device="cpu")


def test_new_backends_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, kw in (("compressed_topk", {}),
                     ("compressed_rand", {"error_feedback": True}),
                     ("async_gossip", {"tau": 1})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pengine.make_mix(name, K=4, **kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pasync.AsyncGossipMix(4)
    assert pengine.make_mix("async_gossip", K=4, device="cpu").device.type \
        == "cpu"
