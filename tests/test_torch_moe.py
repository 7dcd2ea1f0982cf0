"""The port's MoE layer and the small layers its slice adds, against the JAX
package: ``moe_mlp`` (routing, dispatch, the expert FFN, the combine and
the aux losses), LayerNorm, and grok's logit soft-cap in ``unembed`` and
``chunked_ce``.

Both packages get the same numpy inputs and weights. Routing must be equal
exactly: the JAX routing is recomputed from the reference's own lines
(``src/repro/models/moe.py:52-64``), since ``moe_mlp`` returns only its
output and aux values. Outputs agree within ``TOL`` in f32 (one matmul's
sums in another order, ~1e-7 relative) and within one bf16 ulp in bf16.

``moe_mlp`` runs under ``torch.func.vmap`` of ``grad``, as the bilevel
trainer's per-node gradients need: the vmapped gradient equals a loop of
per-node gradients bit for bit (on one thread), for joint grouping with
drops and per-token grouping, and its outputs are bit for bit
those of the layer's earlier form (``F.one_hot`` and an in-place dispatch,
transcribed in :func:`inplace_moe_mlp`), which ``vmap`` could not take.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.layers as jlayers  # noqa: E402
import repro.models.transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.moe import moe_mlp as jax_moe_mlp  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL = 1e-5
D, E, F = 64, 4, 96
BASE = dict(name="moe-test", family="moe", n_layers=1, d_model=D,
            n_heads=4, n_kv_heads=4, d_ff=F, vocab=128, n_experts=E,
            top_k=2)


def configs(dtype="float32", **kw):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = {**BASE, **kw}
    return (JConfig(**kw, dtype=jdt, param_dtype=jnp.float32),
            TConfig(**kw, dtype=tdt, param_dtype=torch.float32))


def weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"router": (rng.standard_normal((D, E)) * D ** -0.5
                       ).astype(np.float32),
            "wi": (rng.standard_normal((E, D, F)) * D ** -0.5
                   ).astype(np.float32),
            "wg": (rng.standard_normal((E, D, F)) * D ** -0.5
                   ).astype(np.float32),
            "wo": (rng.standard_normal((E, F, D)) * F ** -0.5
                   ).astype(np.float32)}


def both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def inputs(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_route(cfg, p, x):
    """The reference's routing lines, on its own arrays: (top_e, pos,
    keep) [G, n*K] and C."""
    B, S, _ = x.shape
    N, K = B * S, cfg.top_k
    G = max(int(cfg.moe_groups), 1)
    if N % G:
        G = 1
    n = N // G
    flat = x.reshape(G, n, D)
    logits = jnp.einsum("gnd,de->gne", flat, p["router"].astype(jnp.float32))
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    C = max(int(cfg.capacity_factor * n * K / cfg.n_experts + 0.999), 4)
    assign = top_e.reshape(G, n * K)
    onehot = jax.nn.one_hot(assign, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < C), C


def port_route(cfg, p, x, per_token=False):
    B, S, _ = x.shape
    N = B * S
    G = N if per_token else max(int(cfg.moe_groups), 1)
    if N % G:
        G = 1
    return tmoe.route(cfg, p, x.reshape(G, N // G, D))


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (f32 numpy): 2**(e - 7)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# (overrides, batch shape): ample capacity, almost everything dropped, some
# but not all dropped, groups, top-1
CASES = {
    "ample": (dict(capacity_factor=8.0), (2, 16)),
    "cf 0.01": (dict(capacity_factor=0.01), (2, 32)),
    "cf 1": (dict(capacity_factor=1.0), (4, 16)),
    "groups 2": (dict(capacity_factor=1.0, moe_groups=2), (4, 16)),
    "top-1": (dict(top_k=1, capacity_factor=1.0), (2, 32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_mlp_matches_jax(case):
    kw, shape = CASES[case]
    jcfg, tcfg = configs(**kw)
    jp, tp = both(weights())
    x = inputs((*shape, D))
    top_e, pos, keep, C = jax_route(jcfg, jp, jnp.asarray(x))
    r = port_route(tcfg, tp, torch.from_numpy(x))
    assert r["C"] == C
    assert np.array_equal(r["top_e"].numpy(), top_e)
    assert np.array_equal(r["pos"].numpy(), pos)
    assert np.array_equal(r["keep"].numpy(), keep)
    dropped = int((~keep).sum())
    if case == "ample":
        assert dropped == 0
    elif case == "cf 0.01":
        assert dropped > keep.size // 2
    else:
        assert 0 < dropped < keep.size, dropped
    # kept destinations are unique: no two assignments share a buffer row
    dest = r["dest"].numpy()
    for g in range(dest.shape[0]):
        kept = dest[g][keep[g]]
        assert len(np.unique(kept)) == len(kept)
        assert (dest[g][~keep[g]] == tcfg.n_experts * C).all()
    jout, jaux = jax_moe_mlp(jcfg, jp, jnp.asarray(x))
    tout, taux = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x))
    assert np.abs(tout.numpy() - np.asarray(jout)).max() < TOL
    for k in ("moe_lb", "moe_z"):
        assert abs(float(taux[k]) - float(jaux[k])) \
            < TOL * max(1.0, abs(float(jaux[k]))), k


def jax_combine(top_w, keep, dest, expert_out):
    """The reference's combine lines (``src/repro/models/moe.py:94-100``)
    on its own arrays: expert_out [E, G, C, D] -> [G, n, D]."""
    E, G, C, D = expert_out.shape
    n, K = top_w.shape[1:]
    dt = expert_out.dtype
    back = expert_out.transpose(1, 0, 2, 3)
    padded = jnp.concatenate(
        [back.reshape(G, E * C, D), jnp.zeros((G, 1, D), dt)], axis=1)
    gathered = jax.vmap(lambda pb, d: jnp.take(pb, d, axis=0))(padded, dest)
    weights = (top_w.reshape(G, n * K) * keep).astype(dt)
    return jnp.sum((gathered * weights[..., None]).reshape(G, n, K, D),
                   axis=2)


def test_moe_mlp_bf16():
    """bf16 activations (f32 weights cast at use, as both packages do).
    Routing is equal. The combine on the same bf16 expert outputs is within
    one bf16 ulp of the reference's (the weighted sum of K = 2 rows rounded
    once). The whole layer's output is within 2 bf16 ulps of each token's
    largest output: each package rounds the expert FFN's hidden h to bf16
    after products summed in its own order, and each stands ~2.5 such ulps
    from the layer computed in f32."""
    jcfg, tcfg = configs("bfloat16", capacity_factor=1.0)
    jp, tp = both(weights())
    x = inputs((4, 16, D))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _, _, keep, C = jax_route(jcfg, jp, xj)
    r = port_route(tcfg, tp, xt)
    assert np.array_equal(r["keep"].numpy(), keep) and not keep.all()
    eo = inputs((E, 1, C, D), seed=5)
    jc = jax_combine(jnp.asarray(r["top_w"].numpy()), jnp.asarray(keep),
                     jnp.asarray(r["dest"].numpy()),
                     jnp.asarray(eo).astype(jnp.bfloat16))
    jc = np.asarray(jc.astype(jnp.float32))
    tc = tmoe.combine(r, torch.from_numpy(eo).to(torch.bfloat16))
    assert (np.abs(tc.float().numpy() - jc) <= bf16_ulp(jc)).all()
    jout = np.asarray(jax_moe_mlp(jcfg, jp, xj)[0].astype(jnp.float32))
    tout = tmoe.moe_mlp(tcfg, tp, xt)[0].float().numpy()
    scale = np.abs(jout).max(axis=-1, keepdims=True)
    assert (np.abs(tout - jout) <= 2 * bf16_ulp(scale)).all()


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities; ``jax.lax.top_k``
    takes the lower expert first, and so must the port."""
    jcfg, tcfg = configs(capacity_factor=8.0)
    w = weights()
    w["router"][:, 3] = w["router"][:, 1]
    w["router"][:, 2] = w["router"][:, 0]
    jp, tp = both(w)
    x = inputs((2, 8, D))
    top_e, _, _, _ = jax_route(jcfg, jp, jnp.asarray(x))
    r = port_route(tcfg, tp, torch.from_numpy(x))
    assert np.array_equal(r["top_e"].numpy(), top_e)
    probs = r["probs"].numpy()
    assert (probs[..., 1] == probs[..., 3]).all()
    assert (np.sort(top_e, axis=-1) == top_e).all()   # lower index first


def test_per_token_routing_differs_from_joint_where_joint_drops():
    """Eight slot tokens routed jointly share C = 4 per expert and drop
    some; routed per token (the reference's vmap over slots) each has its
    own C = 4 >= K and drops none, so the outputs differ exactly on the
    tokens the joint routing dropped."""
    jcfg, tcfg = configs(capacity_factor=0.5)
    jp, tp = both(weights())
    x = inputs((8, 1, D), seed=4)
    joint = port_route(tcfg, tp, torch.from_numpy(x))
    alone = port_route(tcfg, tp, torch.from_numpy(x), per_token=True)
    assert not joint["keep"].all() and alone["keep"].all()
    tj = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x))[0].numpy()
    ts = tmoe.moe_mlp(tcfg, tp, torch.from_numpy(x), per_token=True)[0]
    jv = jax.vmap(lambda o: jax_moe_mlp(jcfg, jp, o[None])[0][0])(
        jnp.asarray(x))
    assert np.abs(ts.numpy() - np.asarray(jv)).max() < TOL
    hit = ~joint["keep"].numpy().reshape(8, 2).all(axis=1)
    diff = np.abs(tj - ts.numpy()).max(axis=(1, 2)) > TOL
    assert np.array_equal(hit, diff)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    x = inputs((3, 5, D), seed=6) * 3 + 1
    rng = np.random.default_rng(7)
    w, b = (rng.standard_normal(D).astype(np.float32) for _ in range(2))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    jy = np.asarray(jlayers.layer_norm(jnp.asarray(x).astype(jdt),
                                       jnp.asarray(w), jnp.asarray(b)
                                       ).astype(jnp.float32))
    ty = tlayers.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            torch.from_numpy(b)).float().numpy()
    if dtype == "float32":
        assert np.abs(ty - jy).max() < TOL
    else:
        assert (np.abs(ty - jy) <= bf16_ulp(jy)).all()
    jcfg, tcfg = configs(norm="layernorm")
    tp = tlayers.make_norm_params(tcfg, D, "cpu")
    assert set(tp) == set(jlayers.make_norm_params(jcfg, D))
    assert (tp["scale"] == 1).all() and (tp["bias"] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_unembed_and_chunked_ce_match_jax(dtype):
    """grok's ``c * tanh(logits / c)`` at c = 2, where it bends the
    logits: in ``unembed`` (the compute dtype) and in ``chunked_ce`` (f32
    logits)."""
    jcfg, tcfg = configs(dtype, logits_softcap=2.0)
    rng = np.random.default_rng(8)
    table = (rng.standard_normal((128, D)) * 0.5).astype(np.float32)
    x = inputs((2, 6, D), seed=9)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = tcfg.dtype
    jl = np.asarray(jlayers.unembed(jcfg, {"table": jnp.asarray(table)},
                                    jnp.asarray(x).astype(jdt)
                                    ).astype(jnp.float32))
    tl = tlayers.unembed(tcfg, {"table": torch.from_numpy(table)},
                         torch.from_numpy(x).to(tdt)).float().numpy()
    assert 1.5 < np.abs(jl).max() <= 2
    if dtype == "float32":
        assert np.abs(tl - jl).max() < TOL
    else:
        assert (np.abs(tl - jl) <= bf16_ulp(jl)).all()
    labels = rng.integers(0, 128, size=(2, 6)).astype(np.int32)
    jce = float(jtf.chunked_ce(jcfg, {"embed": {"table": jnp.asarray(table)}},
                               jnp.asarray(x).astype(jdt),
                               jnp.asarray(labels), chunk=3))
    tce = float(ttf.chunked_ce(tcfg, {"embed": {"table": torch.from_numpy(
        table)}}, torch.from_numpy(x).to(tdt), torch.from_numpy(labels),
        chunk=3))
    plain = float(ttf.chunked_ce(tcfg.with_overrides(logits_softcap=0.0),
                                 {"embed": {"table": torch.from_numpy(
                                     table)}}, torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(labels), chunk=3))
    assert abs(tce - jce) < TOL and abs(tce - plain) > 0.1


def inplace_moe_mlp(cfg, p, x, *, per_token=False):
    """``moe_mlp`` as the port wrote it before it ran under ``vmap``: its
    one-hots by ``F.one_hot`` and its dispatch by an in-place index write;
    everything else as now."""
    B, S, Dm = x.shape
    Ex, K = cfg.n_experts, cfg.top_k
    N = B * S
    G = N if per_token else max(int(cfg.moe_groups), 1)
    if N % G:
        G = 1
    n = N // G
    flat = x.reshape(G, n, Dm)
    logits = flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    C = max(int(cfg.capacity_factor * n * K / Ex + 0.999), 4)
    assign = top_e.reshape(G, n * K)
    onehot = torch.nn.functional.one_hot(assign, Ex).to(torch.int32)
    pos = torch.sum((torch.cumsum(onehot, dim=1) - 1) * onehot, dim=-1)
    keep = pos < C
    dest = torch.where(keep, assign * C + pos, Ex * C)
    rep = torch.repeat_interleave(flat, K, dim=1)
    buf = torch.zeros((G, Ex * C + 1, Dm), dtype=x.dtype)
    groups = torch.arange(G)[:, None]
    buf[groups, dest] = rep
    expert_in = buf[:, :Ex * C].reshape(G, Ex, C, Dm).transpose(0, 1)
    dt = x.dtype
    xe = expert_in.reshape(Ex, G * C, Dm)
    h = torch.nn.functional.silu(torch.bmm(xe, p["wg"].to(dt))) * \
        torch.bmm(xe, p["wi"].to(dt))
    expert_out = torch.bmm(h, p["wo"].to(dt)).reshape(Ex, G, C, Dm)
    r = {"top_e": top_e, "top_w": top_w, "keep": keep, "dest": dest}
    out = tmoe.combine(r, expert_out)
    frac_tokens = torch.mean(torch.nn.functional.one_hot(
        top_e[..., 0], Ex).float(), dim=(0, 1))
    aux_lb = Ex * torch.sum(frac_tokens * torch.mean(probs, dim=(0, 1)))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.reshape(B, S, Dm), {"moe_lb": aux_lb, "moe_z": z_loss}


@pytest.mark.parametrize("per_token", [False, True],
                         ids=["joint", "per-token"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_equal_the_in_place_dispatch_bit_for_bit(case, per_token):
    kw, shape = CASES[case]
    for dtype in ("float32", "bfloat16"):
        _, tcfg = configs(dtype, **kw)
        _, tp = both(weights())
        x = torch.from_numpy(inputs((*shape, D))).to(tcfg.dtype)
        out, aux = tmoe.moe_mlp(tcfg, tp, x, per_token=per_token)
        want, want_aux = inplace_moe_mlp(tcfg, tp, x, per_token=per_token)
        assert torch.equal(out, want)
        assert all(torch.equal(aux[k], want_aux[k]) for k in want_aux)


@pytest.mark.parametrize("per_token", [False, True],
                         ids=["joint", "per-token"])
def test_vmapped_gradient_equals_the_per_node_loop(per_token):
    """Three nodes, each with its own weights and tokens; capacity factor
    1 (joint routing drops, so the overflow row is written and read under
    ``vmap``; per-token routing keeps every token): the gradient of the
    output's square sum plus both aux losses, with respect to the weights
    and the input."""
    _, tcfg = configs(capacity_factor=1.0, moe_groups=2)
    _, tp = both(weights())
    nodes = 3
    ps = {k: torch.stack([v * (1 + 0.25 * i) for i in range(nodes)])
          for k, v in tp.items()}
    xs = torch.from_numpy(inputs((nodes, 4, 16, D)))
    keep = [tmoe.route(tcfg, {k: v[i] for k, v in ps.items()},
                       xs[i].reshape(2, -1, D))["keep"]
            for i in range(nodes)]
    if not per_token:
        assert all((~k).any() for k in keep)

    def loss(p, x):
        out, aux = tmoe.moe_mlp(tcfg, p, x, per_token=per_token)
        return torch.sum(out ** 2) + aux["moe_lb"] + aux["moe_z"]

    grad = torch.func.grad(loss, argnums=(0, 1))
    batched = torch.func.vmap(grad)(ps, xs)
    for i in range(nodes):
        gp, gx = grad({k: v[i] for k, v in ps.items()}, xs[i])
        assert all(torch.equal(batched[0][k][i], gp[k]) for k in gp)
        assert torch.equal(batched[1][i], gx) and float(gx.abs().max()) > 0

