"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's ``repro.optim``: the same updates over 5 steps on the same
gradients, to f32 tolerance, and the same learning rates at every step of a
schedule; plus the reference's own behavioural checks
(``tests/test_substrates.py``) on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402

STEPS = 5
# f32 arithmetic in both: the same operations, a division and a square root
# rounded by two libraries (a few ulps), carried over 5 steps
RTOL, ATOL = 1e-5, 1e-6


def tree(rng):
    """Keys in sorted order, so both packages flatten leaves alike."""
    return {"n": {"b": rng.standard_normal(5).astype(np.float32)},
            "w": rng.standard_normal((6, 5)).astype(np.float32)}


def run_both(make, *, clip=None, steps=STEPS, lr=0.05):
    rng = np.random.default_rng(0)
    p0 = tree(rng)
    grads = [pytree.tree_map(lambda a: 4 * a, tree(rng))
             for _ in range(steps)]
    jinit, jupdate = getattr(joptim, make)()
    tinit, tupdate = getattr(optim, make)()
    jp = jax.tree.map(jnp.asarray, p0)
    tp = pytree.tree_map(torch.from_numpy, p0)
    js, ts = jinit(jp), tinit(tp)
    for g in grads:
        jg = jax.tree.map(jnp.asarray, g)
        tg = pytree.tree_map(torch.from_numpy, g)
        if clip is not None:
            jg = joptim.clip_by_global_norm(jg, clip)
            tg = optim.clip_by_global_norm(tg, clip)
        ju, js = jupdate(jg, js, jp, lr)
        tu, ts = tupdate(tg, ts, tp, lr)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = pytree.tree_map(lambda p, u: p + u, tp, tu)
    return (jp, js), (tp, ts)


def assert_trees_close(j, t):
    jl = [np.asarray(a) for a in jax.tree.leaves(j)]
    tl = [a.numpy() for a in pytree.tree_leaves(t)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("make", ["sgd", "momentum_sgd", "adamw"])
def test_optimizers_match_reference(make, clip):
    (jp, js), (tp, ts) = run_both(make, clip=clip)
    assert_trees_close(jp, tp)
    assert int(js.step) == int(ts.step) == STEPS
    for field in ("mu", "nu"):
        jf, tf = getattr(js, field), getattr(ts, field)
        assert (jf is None) == (tf is None)
        if jf is not None:
            assert_trees_close(jf, tf)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    g = pytree.tree_map(lambda a: 10 * a, tree(rng))
    for max_norm in (0.5, 1e3):
        want = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        got = optim.clip_by_global_norm(pytree.tree_map(torch.from_numpy,
                                                        g), max_norm)
        assert_trees_close(want, got)
    got = optim.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(torch.linalg.norm(got["a"])) <= 1.0 + 1e-5


@pytest.mark.parametrize("make", ["sgd", "momentum_sgd", "adamw"])
def test_optimizers_descend_quadratic(make):
    init, update = getattr(optim, make)()
    params = {"w": torch.tensor([3.0, -2.0])}
    st = init(params)
    for _ in range(50):
        g = {"w": 2 * params["w"]}
        ups, st = update(g, st, params, 0.05)
        params = pytree.tree_map(lambda p, u: p + u, params, ups)
    assert float(params["w"].abs().max()) < 1.0


def test_adamw_keeps_bf16_params_and_f32_moments():
    init, update = optim.adamw()
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = init(p)
    ups, st = update({"w": torch.ones(3, dtype=torch.bfloat16)}, st, p, 0.1)
    assert ups["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32


SCHEDULES = [("constant", (0.3,), {}),
             ("cosine", (1.0, 100), {"warmup": 10}),
             ("cosine", (2.0, 50), {"final_frac": 0.0}),
             ("wsd_schedule", (1.0, 1000), {"warmup_frac": 0.1,
                                            "decay_frac": 0.2}),
             ("wsd_schedule", (3e-3, 200), {})]


@pytest.mark.parametrize("name,args,kw", SCHEDULES)
def test_schedules_match_reference(name, args, kw):
    jf = getattr(joptim, name)(*args, **kw)
    tf = getattr(optim, name)(*args, **kw)
    total = args[1] if len(args) > 1 else 20
    for step in range(0, total + 5, max(total // 40, 1)):
        want, got = jf(step), tf(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


def test_wsd_schedule_phases():
    f = optim.wsd_schedule(1.0, total_steps=1000, warmup_frac=0.1,
                           decay_frac=0.2)
    assert float(f(0)) == 0.0
    assert float(f(50)) == pytest.approx(0.5)
    assert float(f(500)) == pytest.approx(1.0)
    assert float(f(999)) < 0.05
    assert float(f(900)) > float(f(950)) > float(f(999))
