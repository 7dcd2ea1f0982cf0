"""The port's bilevel problem and its hypergradient vs the JAX package's:
``core/topology.py``, ``data/synthetic.py``, ``core/problems.py`` and
``core/hypergrad.py``.

* Topology and data are numpy only in both packages, so W, the spectral
  gap, the drop probabilities, the datasets, splits, shards and
  ``NodeSampler``'s batches must be equal exactly.
* The hypergradient functions run the same f32 arithmetic through other
  autodiff systems (``torch.func`` against ``jax``), so they agree within
  TOL (measured: ≤ 3e-7 at these sizes). The truncation level J̃ is taken
  from the reference's own draw for each key.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.hypergrad as rhg  # noqa: E402
import repro.core.problems as rprob  # noqa: E402
import repro.core.topology as rtopo  # noqa: E402
import repro.data.synthetic as rdata  # noqa: E402
import repro_torch.core.hypergrad as phg  # noqa: E402
import repro_torch.core.problems as pprob  # noqa: E402
import repro_torch.core.topology as ptopo  # noqa: E402
import repro_torch.data.synthetic as pdata  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL = 2e-6
K, D, C, B, J = 4, 12, 3, 8, 4


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

TOPOLOGIES = [("ring", (1,)), ("ring", (2,)), ("ring", (3,)), ("ring", (8,)),
              ("ring", (5, 0.5)), ("complete", (4,)), ("star", (5,)),
              ("torus2d", (2, 3)), ("torus2d", (3, 3)),
              ("erdos_renyi", (6, 0.5, 3)), ("erdos_renyi", (7, 0.3, 0))]


@pytest.mark.parametrize("name,args", TOPOLOGIES)
def test_topology_constructors_equal_exactly(name, args):
    r, p = getattr(rtopo, name)(*args), getattr(ptopo, name)(*args)
    assert (p.name, p.size) == (r.name, r.size)
    assert np.array_equal(p.weights, r.weights)
    assert p.lam == r.lam and p.spectral_gap == r.spectral_gap
    assert [p.neighbors(k) for k in range(p.size)] == [
        r.neighbors(k) for k in range(r.size)]
    p.check_assumption1()


@pytest.mark.parametrize("name,K", [("ring", 6), ("complete", 3),
                                    ("star", 4), ("erdos", 5),
                                    ("torus2x4", 8)])
def test_topology_get_equals_reference(name, K):
    r, p = rtopo.get(name, K), ptopo.get(name, K)
    assert p.name == r.name and np.array_equal(p.weights, r.weights)


def test_edge_delay_model_and_drop_probs_equal_exactly():
    kw = dict(base_s=np.linspace(1e-3, 3e-3, 8), straggler_prob=0.2,
              straggler_scale_s=np.r_[np.zeros(4), np.full(4, 5e-3)])
    r, p = rtopo.EdgeDelayModel(**kw), ptopo.EdgeDelayModel(**kw)
    for fn in ("sample", "sync_round_s"):
        a = getattr(r, fn)(np.random.default_rng(3), 8, rounds=5)
        b = getattr(p, fn)(np.random.default_rng(3), 8, rounds=5)
        assert np.array_equal(a, b)
    assert p.adaptive_deadline(0.9, n_edges=8) == r.adaptive_deadline(
        0.9, n_edges=8)
    for deadline in (5e-4, 2e-3, 1e-2):
        assert np.array_equal(p.drop_prob(deadline, 8),
                              r.drop_prob(deadline, 8))
        assert np.array_equal(ptopo.ring_edge_drop_probs(p, 4, deadline),
                              rtopo.ring_edge_drop_probs(r, 4, deadline))
    with pytest.raises(ValueError):
        p.adaptive_deadline(1.5, n_edges=8)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def datasets(mod, n=400, d=D, c=C, seed=0):
    ds = mod.make_classification(n=n, d=d, c=c, seed=seed)
    tr, va = mod.train_val_split(ds, 0.3, seed=seed)
    return ds, tr, va


def test_datasets_splits_and_shards_equal_bit_for_bit():
    for seed in (0, 5):
        for r, p in zip(datasets(rdata, seed=seed),
                        datasets(pdata, seed=seed)):
            assert r.a.dtype == p.a.dtype and r.b.dtype == p.b.dtype
            assert np.array_equal(r.a, p.a) and np.array_equal(r.b, p.b)
        _, rtr, _ = datasets(rdata, seed=seed)
        _, ptr, _ = datasets(pdata, seed=seed)
        for r, p in zip(rdata.shard_to_nodes(rtr, K),
                        pdata.shard_to_nodes(ptr, K)):
            assert np.array_equal(r.a, p.a) and np.array_equal(r.b, p.b)
        for r, p in zip(rdata.shard_to_nodes_noniid(rtr, K, 0.3, seed),
                        pdata.shard_to_nodes_noniid(ptr, K, 0.3, seed)):
            assert np.array_equal(r.a, p.a) and np.array_equal(r.b, p.b)


def samplers(seed=7):
    out = []
    for mod in (rdata, pdata):
        _, tr, va = datasets(mod)
        out.append(mod.NodeSampler(mod.shard_to_nodes(tr, K),
                                   mod.shard_to_nodes(va, K), batch=B, J=J,
                                   seed=seed))
    return out


def test_node_sampler_batches_equal_bit_for_bit():
    rs, ps = samplers()
    assert not ps.device_resident
    for _ in range(5):
        r, p = rs.sample(None), ps.sample(torch.Generator())
        for part, shape in (("f", (K, B)), ("g", (K, B)), ("h", (K, J, B))):
            assert tuple(p[part]["a"].shape) == shape + (D,)
            assert tuple(p[part]["b"].shape) == shape
            for leaf in ("a", "b"):
                assert p[part][leaf].device.type == "cpu"
                assert np.array_equal(np.asarray(r[part][leaf]),
                                      p[part][leaf].numpy())
    for n in (2048, 17):
        r, p = rs.eval_batch(n), ps.eval_batch(n)
        assert np.array_equal(np.asarray(r["a"]), p["a"].numpy())
        assert np.array_equal(np.asarray(r["b"]), p["b"].numpy())


def test_device_sampler_draws_in_range_per_node_with_right_shapes():
    """Distribution test (its stream is a torch.Generator's, not
    jax.random's): each drawn row is a row of its own node's shard, each
    label is that row's, every index of a node is reachable, and the draws
    are a pure function of the generator's state."""
    _, tr, va = datasets(pdata, n=120)
    trn, van = pdata.shard_to_nodes(tr, K), pdata.shard_to_nodes(va, K)
    smp = pdata.make_device_sampler(trn, van, batch=B, J=J, device="cpu")
    assert smp.device_resident
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in range(K)]
    for _ in range(60):
        batch = smp(gen)
        for part, nodes, shape in (("f", van, (K, B)), ("g", trn, (K, B)),
                                   ("h", trn, (K, J, B))):
            a, b = batch[part]["a"], batch[part]["b"]
            assert tuple(a.shape) == shape + (D,) and tuple(b.shape) == shape
            assert a.dtype == torch.float32 and b.dtype == torch.int32
            for k in range(K):
                rows = a[k].reshape(-1, D).numpy()
                labels = b[k].reshape(-1).numpy()
                match = (rows[:, None, :] == nodes[k].a[None]).all(-1)
                assert (match.sum(1) == 1).all()
                idx = match.argmax(1)
                assert np.array_equal(nodes[k].b[idx], labels)
                if part != "f":
                    seen[k].update(idx.tolist())
    assert all(s == set(range(trn[0].n)) for s in seen)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    x, y = smp(g1), smp(g2)
    assert torch.equal(x["h"]["a"], y["h"]["a"])
    assert not torch.equal(smp(g1)["h"]["a"], x["h"]["a"])


# ---------------------------------------------------------------------------
# problems and the hypergradient
# ---------------------------------------------------------------------------

def to_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def close(p, r, tol=TOL):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=tol,
                               atol=tol)


def logreg_case(seed=0):
    """(reference problem, port problem, x, y, fbatch, gbatch, hbatches) as
    numpy: a logreg problem with non-zero x so the regulariser's cross term
    is live."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.normal(size=(D,)).astype(np.float32)
    y = 0.3 * rng.normal(size=(D, C)).astype(np.float32)

    def batch(*lead):
        return {"a": rng.normal(size=lead + (B, D)).astype(np.float32),
                "b": rng.integers(0, C, size=lead + (B,)).astype(np.int32)}

    return (rprob.logreg_hyperopt(D, C, lip_gy=5.0),
            pprob.logreg_hyperopt(D, C, lip_gy=5.0), x, y, batch(), batch(),
            batch(J))


def quad_case(seed=0):
    """The quadratic problem, the port's built from the reference oracle's
    A, B, b and c; batches are zero shifts (the reference's are keys,
    ignored without noise)."""
    rp, orc = rprob.quadratic_problem(dx=5, dy=7, seed=seed)
    pp, porc = pprob.quadratic_from_arrays(
        *(np.asarray(orc[k]) for k in "ABbc"), device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5,)).astype(np.float32)
    y = rng.normal(size=(7,)).astype(np.float32)
    return rp, pp, x, y, orc, porc


def test_logreg_losses_and_accuracy_match():
    rp, pp, x, y, fb, gb, _ = logreg_case()
    for fn in ("upper_loss", "lower_loss"):
        close(getattr(pp, fn)(*to_t((x, y, fb))),
              getattr(rp, fn)(x, y, fb))
    close(pprob.accuracy(*to_t((y, gb))), rprob.accuracy(y, gb), 0)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(pp.init_x(gen, "cpu"), torch.zeros(D))
    assert pp.init_y(gen, "cpu").shape == (D, C)


@pytest.mark.parametrize("seed", range(3))
def test_hvp_and_cross_term_match_on_both_problems(seed):
    rp, pp, x, y, fb, _, _ = logreg_case(seed)
    v = np.random.default_rng(seed + 9).normal(size=y.shape).astype(np.float32)
    w = np.random.default_rng(seed + 7).normal(size=y.shape).astype(np.float32)
    close(phg.hvp_yy(pp.lower_loss, *to_t((x, y, fb, v))),
          rhg.hvp_yy(rp.lower_loss, x, y, fb, v))
    close(phg.jvp_xy(pp.lower_loss, *to_t((x, y, fb, w))),
          rhg.jvp_xy(rp.lower_loss, x, y, fb, w))
    rq, pq, xq, yq, orc, _ = quad_case(seed)
    vq = np.ones_like(yq)
    close(phg.hvp_yy(pq.lower_loss, *to_t((xq, yq)), None, torch.ones(7)),
          rhg.hvp_yy(rq.lower_loss, xq, yq, jax.random.PRNGKey(0), vq))
    close(phg.hvp_yy(pq.lower_loss, *to_t((xq, yq)), None, torch.ones(7)),
          np.asarray(orc["A"]) @ vq)
    close(phg.jvp_xy(pq.lower_loss, *to_t((xq, yq)), None, torch.ones(7)),
          rhg.jvp_xy(rq.lower_loss, xq, yq, jax.random.PRNGKey(0), vq))


@pytest.mark.parametrize("key", range(6))
def test_stochastic_hypergrad_matches_at_the_reference_jtilde(key):
    """randomize=True: the port is handed the J̃ the reference draws from
    the same key; randomize=False: all J terms on both sides. Both
    problems."""
    rp, pp, x, y, fb, gb, hb = logreg_case(key)
    rhb = jax.tree.map(jnp.asarray, hb)  # indexed by a traced j
    k = jax.random.PRNGKey(key)
    jt = int(jax.random.randint(k, (), 0, J))
    cfg_r = rhg.HypergradConfig(J=J, lip_gy=5.0, randomize=True)
    cfg_p = phg.HypergradConfig(J=J, lip_gy=5.0, randomize=True)
    close(phg.stochastic_hypergrad(pp, cfg_p, *to_t((x, y, fb, gb, hb)),
                                   torch.tensor(jt)),
          rhg.stochastic_hypergrad(rp, cfg_r, x, y, fb, gb, rhb, k))
    det_r = rhg.HypergradConfig(J=J, lip_gy=5.0, randomize=False)
    det_p = phg.HypergradConfig(J=J, lip_gy=5.0, randomize=False)
    close(phg.stochastic_hypergrad(pp, det_p, *to_t((x, y, fb, gb, hb)),
                                   None),
          rhg.stochastic_hypergrad(rp, det_r, x, y, fb, gb, rhb, None))
    with pytest.raises(ValueError, match="jtilde"):
        phg.stochastic_hypergrad(pp, cfg_p, *to_t((x, y, fb, gb, hb)), None)
    # the quadratic: the reference's batches are keys (no noise: ignored),
    # the port's zero shifts of b
    rq, pq, xq, yq, _, _ = quad_case(key)
    close(phg.stochastic_hypergrad(pq, cfg_p, *to_t((xq, yq)), None, None,
                                   torch.zeros(J, 7), torch.tensor(jt)),
          rhg.stochastic_hypergrad(rq, cfg_r, xq, yq, k, k,
                                   jax.random.split(k, J), k))


def test_neumann_jtilde_zero_and_J_zero():
    """J̃ = 0 keeps no factor: (J/L) v; J = 0 gives zeros."""
    _, pp, x, y, _, _, hb = logreg_case()
    v = torch.ones(D, C)
    cfg = phg.HypergradConfig(J=J, lip_gy=5.0)
    out = phg.neumann_inverse_hvp(pp.lower_loss, *to_t((x, y)), v,
                                  to_t(hb), cfg, torch.tensor(0))
    assert torch.equal(out, (J / 5.0) * v)
    out = phg.neumann_inverse_hvp(pp.lower_loss, *to_t((x, y)), v, to_t(hb),
                                  phg.HypergradConfig(J=0), None)
    assert torch.equal(out, torch.zeros(D, C))


@pytest.mark.parametrize("problem", ["logreg", "quadratic"])
def test_expected_and_exact_hypergrad_match(problem):
    if problem == "logreg":
        rp, pp, x, y, fb, _, _ = logreg_case(4)
        rb, pb = fb, to_t(fb)
    else:
        rp, pp, x, y, _, _ = quad_case(4)
        rb, pb = jax.random.PRNGKey(0), None
    cfg_r = rhg.HypergradConfig(J=J, lip_gy=5.0)
    cfg_p = phg.HypergradConfig(J=J, lip_gy=5.0)
    close(phg.expected_hypergrad(pp, cfg_p, *to_t((x, y)), pb),
          rhg.expected_hypergrad(rp, cfg_r, x, y, rb))
    close(phg.exact_hypergrad_dense(pp, *to_t((x, y)), pb),
          rhg.exact_hypergrad_dense(rp, x, y, rb), 1e-5)


def test_quadratic_closed_form_matched():
    """At y = y*(x), the deterministic Neumann sum with J large, the dense
    exact hypergradient and the reference's closed form agree (A's spectrum
    in [0.5, 2] and L = 2: the J = 40 series' tail is 0.75**40 ~ 1e-5 of
    it). The randomized estimator averaged over every J̃ in {0..J-1} is
    that sum (Lemma 2)."""
    rq, pq, x, _, orc, porc = quad_case(1)
    xt = torch.from_numpy(x)
    ystar = porc["y_star"](xt)
    close(ystar, orc["y_star"](x))
    closed = orc["hypergrad"](jnp.asarray(x))
    close(porc["hypergrad"](xt), closed, 1e-5)
    cfg = phg.HypergradConfig(J=40, lip_gy=2.0, randomize=True)
    expected = phg.expected_hypergrad(pq, cfg, xt, ystar, None)
    close(expected, closed, 1e-4)
    shifts = torch.zeros(40, 7)
    mean = sum(phg.stochastic_hypergrad(pq, cfg, xt, ystar, None, None,
                                        shifts, torch.tensor(j))
               for j in range(40)) / 40
    close(mean, expected.numpy(), 1e-5)
    close(phg.exact_hypergrad_dense(pq, xt, ystar, None), closed, 1e-5)
    close(porc["x_star"](), orc["x_star"](), 1e-5)
    assert float(porc["hypergrad"](porc["x_star"]()).abs().max()) < 1e-5


def test_quadratic_noisy_batch_is_the_shift():
    """The noisy quadratic's batch is the drawn shift of b itself."""
    rq, orc = rprob.quadratic_problem(dx=3, dy=4, seed=2)
    pq, porc = pprob.quadratic_from_arrays(
        *(np.asarray(orc[k]) for k in "ABbc"), noise=0.5, device="cpu")
    gen = torch.Generator().manual_seed(0)
    shift = porc["draw_shift"](gen)
    assert shift.shape == (4,) and float(shift.abs().sum()) > 0
    x, y = torch.randn(3, generator=gen), torch.randn(4, generator=gen)
    g0 = torch.func.grad(pq.lower_loss, argnums=1)(x, y, None)
    g1 = torch.func.grad(pq.lower_loss, argnums=1)(x, y, shift)
    close(g0 - g1, shift.numpy())
    q, _ = pprob.quadratic_problem(dx=3, dy=4, seed=0, device="cpu")
    assert q.lip_gy == 2.0 and q.mu == 0.5


def test_tree_helpers_take_dict_parameters():
    """Dict parameters (as the LM trainer will pass) go through the tree
    helpers and the hypergradient unchanged."""
    rng = np.random.default_rng(0)
    a = {"w": torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32)),
         "b": torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))}
    b = phg.tree_scale(2.0, a)
    close(phg.tree_dot(a, b), 2 * sum(float((t * t).sum()) for t in
                                      a.values()), 1e-6)
    close(phg.tree_norm(a), np.sqrt(sum(float((t * t).sum())
                                        for t in a.values())), 1e-6)
    assert torch.equal(phg.tree_axpy(1.0, a, b)["w"], a["w"] + b["w"])
    assert torch.equal(phg.tree_sub(b, a)["b"], a["b"])
    assert torch.equal(phg.tree_zeros_like(a)["w"], torch.zeros(3, 2))
    feats = torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
    labels = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)

    def g(x, y, batch):
        logits = batch["a"] @ y["w"] + y["b"]
        reg = (torch.mean(torch.exp(x)[:, None] * y["w"] ** 2)
               + 0.1 * torch.sum(y["b"] ** 2))
        return pprob._softmax_xent(logits, batch["b"]) + reg

    def f(x, y, batch):
        return pprob._softmax_xent(batch["a"] @ y["w"] + y["b"], batch["b"])

    prob = pprob.BilevelProblem(f, g, None, None, lip_gy=5.0)
    batch = {"a": feats, "b": labels}
    x = torch.zeros(3)
    hv = phg.hvp_yy(g, x, a, batch, a)
    assert set(hv) == {"w", "b"} and hv["w"].shape == (3, 2)
    exact = phg.exact_hypergrad_dense(prob, x, a, batch)
    cfg = phg.HypergradConfig(J=400, lip_gy=5.0)
    est = phg.expected_hypergrad(prob, cfg, x, a, batch)
    assert est.shape == x.shape
    close(est, exact.numpy(), 1e-4)


def test_draw_jtilde_range():
    cfg = phg.HypergradConfig(J=5)
    jt = phg.draw_jtilde(cfg, (4000,), torch.Generator().manual_seed(0))
    assert jt.dtype == torch.int64
    assert set(jt.tolist()) == set(range(5))
