"""The port's decentralized run vs the JAX package's, on the dense mix:
``core/tracking.py``, ``estimators.py``, ``common.py``, the algorithms and
``Engine`` with per-step dispatch.

Whole-run parity: the reference ``Engine(..., dispatch="per_step")`` and
the port's ``Engine(device="cpu")`` run the logreg problem from the same
x0/y0 on ``NodeSampler(seed)`` batches (equal bit for bit in both
packages), with the paper's randomized truncation. The port is handed the
reference's own J̃, recomputed from its ``key_schedule``. Both sides run the
same f32 arithmetic through other libraries, so the losses, the consensus
errors at each eval and the final state agree within TOL_LOSS, TOL_CONS
(relative) and TOL_STATE. Measured at these sizes: loss ≤ 1.2e-7,
consensus ≤ 6.2e-7 relative, state ≤ 4.5e-8.

The reference runs are built once per module (a module-scoped fixture).
``test_torch_bilevel_engine.py`` holds the ``ring_rolled`` mix and the
fused dispatch, with the helpers of this file.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.common as rcommon  # noqa: E402
import repro.core.engine as rengine  # noqa: E402
import repro.core.estimators as rest  # noqa: E402
import repro.core.tracking as rtrack  # noqa: E402
import repro_torch.core.common as pcommon  # noqa: E402
import repro_torch.core.estimators as pest  # noqa: E402
import repro_torch.core.tracking as ptrack  # noqa: E402
from repro.core import HParams as RHParams  # noqa: E402
from repro.core import HypergradConfig as RCfg  # noqa: E402
from repro.core import logreg_hyperopt as rlogreg  # noqa: E402
from repro.core import ring as rring  # noqa: E402
from repro.data import synthetic as rdata  # noqa: E402
from repro_torch.core import Engine, HParams, HypergradConfig  # noqa: E402
from repro_torch.core import logreg_hyperopt, ring  # noqa: E402
from repro_torch.data import synthetic as pdata  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

K, D, J, B, STEPS, EVAL, SEED = 4, 16, 4, 8, 20, 5, 0
ALGOS = ("mdbo", "vrdbo", "dsbo", "gdsbo", "gt_sgd")
# the paper's step sizes (benchmarks/common.py, PAPER_HP)
HP = {"vrdbo": (0.33, 5.0, 5.0, 1.0, 1.0)}
HP_DEFAULT = (0.1, 1.0, 1.0, 1.0, 1.0)
TOL_LOSS, TOL_CONS, TOL_STATE = 1e-5, 1e-4, 1e-5
TOL = 2e-6   # one mix, update or gradient call


def reference_jtilde(seed, K, J, steps) -> np.ndarray:
    """``[steps + 1, K]``: the J̃ the reference's ``Engine.run`` draws —
    its init keys, then ``key_schedule``'s per-step node keys, each through
    ``jax.random.randint(key, (), 0, J)`` as ``neumann_inverse_hvp`` does."""
    key = jax.random.PRNGKey(seed)
    _, _, key = jax.random.split(key, 3)
    key, k0 = jax.random.split(key)
    _, kn0 = jax.random.split(k0)
    _, kns = rengine.key_schedule(key, steps)
    rows = [jax.random.split(kn0, K)] + [jax.random.split(kns[t], K)
                                         for t in range(steps)]
    draw = jax.vmap(lambda k: jax.random.randint(k, (), 0, J))
    return np.stack([np.asarray(draw(r)) for r in rows])


def x0_y0():
    rng = np.random.default_rng(1)
    return (np.zeros(D, np.float32),
            (0.01 * rng.normal(size=(D, 2))).astype(np.float32))


def sampler(mod):
    ds = mod.make_classification(n=600, d=D, c=2, seed=SEED)
    tr, va = mod.train_val_split(ds, 0.3, seed=SEED)
    return mod.NodeSampler(mod.shard_to_nodes(tr, K),
                           mod.shard_to_nodes(va, K), batch=B, J=J, seed=SEED)


def reference_run(algo, mix, steps=STEPS):
    x0, y0 = x0_y0()
    eng = rengine.Engine(rlogreg(d=D, lip_gy=5.0), RCfg(J=J, lip_gy=5.0),
                         RHParams(*HP.get(algo, HP_DEFAULT)), rring(K),
                         algo=algo, mix=mix, dispatch="per_step")
    smp = sampler(rdata)
    res, state = eng.run(smp, smp.eval_batch(), steps=steps, seed=SEED,
                         eval_every=EVAL, x0=jnp.asarray(x0),
                         y0=jnp.asarray(y0), return_state=True)
    return res, [np.asarray(t) for t in state]


def port_engine(algo, mix, dispatch="per_step", device="cpu"):
    return Engine(logreg_hyperopt(d=D, lip_gy=5.0),
                  HypergradConfig(J=J, lip_gy=5.0),
                  HParams(*HP.get(algo, HP_DEFAULT)), ring(K), algo=algo,
                  mix=mix, dispatch=dispatch, device=device)


def port_run(algo, mix, dispatch="per_step", steps=STEPS, jtilde=None,
             **kw):
    x0, y0 = x0_y0()
    smp = sampler(pdata)
    if jtilde is None:
        jtilde = reference_jtilde(SEED, K, J, steps)
    return port_engine(algo, mix, dispatch).run(
        smp, smp.eval_batch(), steps=steps, seed=SEED, eval_every=EVAL,
        x0=x0, y0=y0, return_state=True, jtilde=jtilde, **kw)


def assert_run_parity(ref, port):
    (rres, rstate), (pres, pstate) = ref, port
    assert pres.steps == rres.steps
    for name in ("upper_loss", "lower_loss"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=0, atol=TOL_LOSS)
    for name in ("consensus_x", "consensus_y"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=TOL_CONS, atol=1e-12)
    assert len(pstate) == len(rstate)
    for p, r in zip(pstate, rstate):
        assert tuple(p.shape) == r.shape
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=TOL_STATE)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's per-step runs on the dense mix, built once."""
    return {algo: reference_run(algo, "dense") for algo in ALGOS}


@pytest.mark.parametrize("algo", ALGOS)
def test_whole_run_parity_dense(reference_runs, algo):
    port = port_run(algo, "dense")
    assert_run_parity(reference_runs[algo], port)
    res = port[0]
    assert res.upper_loss[-1] < res.upper_loss[0]


def test_reference_jtilde_schedule_is_the_reference_draw():
    """The recomputed schedule covers {0..J-1} and differs per node and
    step (so the runs above exercise randomized truncation)."""
    jt = reference_jtilde(SEED, K, J, STEPS)
    assert jt.shape == (STEPS + 1, K)
    assert set(np.unique(jt)) == set(range(J))
    assert len({tuple(r) for r in jt}) > STEPS // 2


# ---------------------------------------------------------------------------
# tracking and estimators
# ---------------------------------------------------------------------------

def tree(K, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(K, 3, 2)).astype(np.float32),
            "b": rng.normal(size=(K, 5)).astype(np.float32)}


def to_t(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def close(p, r, tol=TOL):
    for a, b in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), p)), jax.tree.leaves(r)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("K_", [1, 2, 3, 5])
def test_mixes_match_reference_and_ring_rolled_equals_dense(K_):
    from repro_torch.core import topology as ptopo

    t = tree(K_)
    for W in (ptopo.ring(K_).weights, ptopo.erdos_renyi(K_, 0.6, 1).weights):
        close(ptrack.dense_mix(W, "cpu")(to_t(t)), rtrack.dense_mix(W)(t))
    for sw in (1.0 / 3.0, 0.5):
        rolled = ptrack.ring_mix_rolled(sw)(to_t(t))
        close(rolled, rtrack.ring_mix_rolled(sw)(t))
        close(rolled, ptrack.dense_mix(ptopo.ring(K_, sw).weights, "cpu")(
            to_t(t)))


@pytest.mark.parametrize("mix", ["dense", "ring_rolled"])
def test_tracking_invariant_and_updates_match(mix):
    """mean_k Z_t = mean_k U_t after every tracking update (Eq. 8), and
    track/param/gossip updates match the reference's."""
    Kn = 5
    pmix = (ptrack.dense_mix(ring(Kn).weights, "cpu") if mix == "dense"
            else ptrack.ring_mix_rolled())
    rmix = (rtrack.dense_mix(rring(Kn).weights) if mix == "dense"
            else rtrack.ring_mix_rolled())
    u = tree(Kn, 0)
    z = u
    pz = to_t(z)
    for s in range(1, 6):
        u_new = tree(Kn, s)
        rz = rtrack.track_update(z, u_new, u, rmix)
        pz = ptrack.track_update(pz, to_t(u_new), to_t(u), pmix)
        close(pz, rz, 1e-5)
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     pz)),
                        jax.tree.leaves(u_new)):
            np.testing.assert_allclose(a.mean(0), b.mean(0), atol=1e-5)
        z, u = rz, u_new
    x, d = tree(Kn, 7), tree(Kn, 8)
    close(ptrack.param_update(to_t(x), to_t(d), 0.1, 0.5, pmix),
          rtrack.param_update(x, d, 0.1, 0.5, rmix))
    close(ptrack.gossip_param_update(to_t(x), to_t(d), 0.3, pmix),
          rtrack.gossip_param_update(x, d, 0.3, rmix))


def test_estimators_match():
    u, g1, g2 = tree(3, 0), tree(3, 1), tree(3, 2)
    close(pest.momentum_update(to_t(u), to_t(g1), 0.3),
          rest.momentum_update(u, g1, 0.3))
    close(pest.storm_update(to_t(u), to_t(g1), to_t(g2), 0.05),
          rest.storm_update(u, g1, g2, 0.05))
    close(pest.sgd_update(to_t(u), to_t(g1), 0.3),
          rest.sgd_update(u, g1, 0.3))


def test_common_helpers_match():
    t = tree(4, 3)
    close(pcommon.consensus_error(to_t(t)), rcommon.consensus_error(t))
    close(pcommon.node_mean(to_t(t)), rcommon.node_mean(t))
    single = {"w": np.ones((3, 2), np.float32)}
    rep = pcommon.replicate(to_t(single), 4)
    close(rep, rcommon.replicate(single, 4), 0)
    rep["w"][0, 0, 0] = 5.0          # each node owns its copy
    assert float(rep["w"][1, 0, 0]) == 1.0


@pytest.mark.parametrize("randomize", [True, False])
def test_node_grads_match_with_per_node_jtilde(randomize):
    """vmapped over the node axis, node k with the J̃ its key draws."""
    ps = sampler(pdata)
    rs = sampler(rdata)
    rb, pb = rs.sample(None), ps.sample(None)
    x0, y0 = x0_y0()
    rng = np.random.default_rng(5)
    X = (0.3 * rng.normal(size=(K, D))).astype(np.float32)
    Y = np.broadcast_to(y0, (K,) + y0.shape) + (
        0.1 * rng.normal(size=(K, D, 2))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), K)
    jt = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, J))(keys))
    rcfg = RCfg(J=J, lip_gy=5.0, randomize=randomize)
    pcfg = HypergradConfig(J=J, lip_gy=5.0, randomize=randomize)
    rdf, rdg = rcommon.node_grads(rlogreg(d=D, lip_gy=5.0), rcfg, X, Y, rb,
                                  keys)
    pdf, pdg = pcommon.node_grads(logreg_hyperopt(d=D, lip_gy=5.0), pcfg,
                                  *to_t((X, Y)), pb, torch.from_numpy(jt))
    close(pdf, rdf)
    close(pdg, rdg)
