"""The port's decentralized bilevel LM trainer vs the JAX package's:
``repro_torch.train``, ``repro_torch.data.lm``, ``repro_torch.checkpoint``
and ``repro_torch.launch.train``.

Whole-run parity: the reference ``make_trainer_engine(...,
dispatch="per_step")`` and the port's (``device="cpu"``) run from the same
x0 and θ0 (the reference's, carried over) on the reference's own batches
(recomputed from its ``key_schedule`` with its ``make_lm_step_batch`` and
handed to the port in order) and J̃ (``reference_jtilde``), for ``mdbo``,
``vrdbo`` and ``gt_sgd`` on a tiny dense model and ``mdbo`` on a tiny ssm
and a tiny moe model (phi3.5-moe, 4 experts top-2), K = 2, J = 2 with
randomized truncation. Both run the same f32
arithmetic through other libraries, so every eval's losses agree within
TOL_LOSS, the consensus errors within TOL_CONS relative (or 1e-12: the
x consensus is rounding noise, ~1e-13), and every leaf of the final state
within TOL_STATE of its largest magnitude. Measured at these sizes: losses
≤ 2.4e-6, consensus ≤ 6.2e-7 relative, state ≤ 8.5e-6 of the leaf's
largest entry.

The reference runs are built once per module (a module-scoped fixture).
The card's side is ``tests/test_torch_trainer_cuda.py`` and phase 13 of
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as rckpt  # noqa: E402
import repro.configs  # noqa: E402
import repro.data as rdata  # noqa: E402
import repro.models  # noqa: E402
import repro.train as rtrain  # noqa: E402
import repro_torch.checkpoint as pckpt  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.core.engine as pengine  # noqa: E402
import repro_torch.core.tracking as ptrack  # noqa: E402
import repro_torch.data as pdata  # noqa: E402
import repro_torch.train as ptrain  # noqa: E402
from repro.core import HParams as RHParams  # noqa: E402
from repro.core.engine import key_schedule  # noqa: E402
from repro_torch.core import HParams, ring  # noqa: E402
from repro_torch.launch import train as ptrain_cli  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_torch_bilevel_run import reference_jtilde  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
K, B, S, J, STEPS, EVAL, SEED = 2, 2, 8, 2, 4, 2, 0
TOL_LOSS, TOL_CONS, TOL_STATE = 1e-5, 1e-4, 1e-4
NARROW = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
              vocab=64)
ARCHS = {"dense": "smollm-360m", "ssm": "rwkv6-1.6b",
         "moe": "phi3.5-moe-42b-a6.6b", "vlm": "chameleon-34b",
         "audio": "whisper-tiny"}
RUNS = [("mdbo", "dense"), ("vrdbo", "dense"), ("gt_sgd", "dense"),
        ("mdbo", "ssm"), ("mdbo", "moe")]
HP = dict(eta=0.1, beta1=0.05, beta2=0.5)


def configs(family):
    arch = ARCHS[family]
    return (repro.configs.get(arch).reduced().with_overrides(**NARROW),
            repro_torch.configs.get(arch).reduced().with_overrides(**NARROW))


def reference_batches(jcfg, seed, steps):
    """The step batches the reference's ``Engine.run`` draws through its
    device LM sampler: the init batch, then one per ``key_schedule`` key."""
    key = jax.random.PRNGKey(seed)
    _, _, key = jax.random.split(key, 3)
    key, k0 = jax.random.split(key)
    kb0, _ = jax.random.split(k0)
    kbs, _ = key_schedule(key, steps)
    keys = [kb0] + [kbs[t] for t in range(steps)]
    return [jax.tree.map(np.asarray, rdata.make_lm_step_batch(
        jcfg, k, K, B, S, J=J)) for k in keys]


def replay(batches):
    """A sampler that hands the engine ``batches`` in order."""
    it = iter(batches)
    return lambda generator: jax.tree.map(torch.from_numpy, next(it))


def x0_y0(jcfg):
    x0 = np.full((rtrain.x_dim(jcfg),), -4.0, np.float32)
    y0 = jax.tree.map(np.asarray, repro.models.init_params(
        jcfg, jax.random.PRNGKey(1)))
    return x0, y0


def eval_batch(jcfg):
    return jax.tree.map(np.asarray, rdata.make_node_batch(
        jcfg, jax.random.PRNGKey(SEED + 17), B, S))


def reference_run(algo, family):
    jcfg, _ = configs(family)
    tc = rtrain.TrainerConfig(algo=algo, J=J, mix="ring",
                              hp=RHParams(**HP))
    _, eng = rtrain.make_trainer_engine(jcfg, tc, K, dispatch="per_step")
    x0, y0 = x0_y0(jcfg)
    sampler = rdata.make_device_lm_sampler(jcfg, tc, K, B, S)
    res, state = eng.run(sampler, eval_batch(jcfg), steps=STEPS, seed=SEED,
                         eval_every=EVAL, x0=jnp.asarray(x0),
                         y0=jax.tree.map(jnp.asarray, y0), return_state=True)
    return res, state


def port_engine(algo, family, dispatch="per_step"):
    _, tcfg = configs(family)
    tc = ptrain.TrainerConfig(algo=algo, J=J, mix="ring", hp=HParams(**HP))
    return ptrain.make_trainer_engine(tcfg, tc, K, dispatch=dispatch,
                                      device="cpu")[1]


def port_run(algo, family, dispatch="per_step"):
    jcfg, _ = configs(family)
    x0, y0 = x0_y0(jcfg)
    return port_engine(algo, family, dispatch).run(
        replay(reference_batches(jcfg, SEED, STEPS)),
        jax.tree.map(torch.from_numpy, eval_batch(jcfg)), steps=STEPS,
        seed=SEED, eval_every=EVAL, x0=torch.from_numpy(x0),
        y0=params_from_jax(y0, device="cpu"), return_state=True,
        jtilde=reference_jtilde(SEED, K, J, STEPS))


def leaves(tree):
    """{JAX keystr: numpy leaf} of a port tree (dicts, lists, tuples)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}['{k}']")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
        else:
            out[path] = t.detach().float().numpy() if (
                t.dtype == torch.bfloat16) else t.detach().numpy()

    walk(tree, "")
    return out


def jleaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's per-step runs, built once."""
    return {run: reference_run(*run) for run in RUNS}


@pytest.mark.parametrize("algo,family", RUNS,
                         ids=[f"{a}-{f}" for a, f in RUNS])
def test_whole_run_parity(reference_runs, algo, family):
    rres, rstate = reference_runs[(algo, family)]
    pres, pstate = port_run(algo, family)
    assert pres.steps == rres.steps == [0, 2, 4]
    for name in ("upper_loss", "lower_loss"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=0, atol=TOL_LOSS)
    for name in ("consensus_x", "consensus_y"):
        np.testing.assert_allclose(getattr(pres, name), getattr(rres, name),
                                   rtol=TOL_CONS, atol=1e-12)
    # the named fields as JAX flattens a NamedTuple: ``[i]`` in field order
    p, r = leaves(tuple(pstate)), jleaves(tuple(rstate))
    assert p.keys() == r.keys()
    for k in r:
        scale = max(float(np.abs(r[k]).max()), 1e-30)
        np.testing.assert_allclose(p[k], r[k], rtol=0,
                                   atol=TOL_STATE * scale, err_msg=k)
    assert all(np.isfinite(pres.upper_loss))


def assert_fused_equals_per_step(algo, family):
    """Both dispatches on the engine's own randomness (the LM batches from
    its batch generator, J̃ from its own, the initial weights from its init
    generator): every eval and every state leaf bit for bit."""
    _, tcfg = configs(family)
    tc = ptrain.TrainerConfig(algo=algo, J=J, mix="ring", hp=HParams(**HP))
    sampler = pdata.make_device_lm_sampler(tcfg, tc, K, B, S)
    ev = pdata.make_node_batch(tcfg, torch.Generator().manual_seed(9), B, S)
    out = [port_engine(algo, family, dispatch).run(
        sampler, ev, steps=3, seed=3, eval_every=2, return_state=True)
        for dispatch in ("per_step", "fused")]
    (rp, sp), (rf, sf) = out
    assert rp.upper_loss == rf.upper_loss and rp.steps == [0, 2, 3]
    assert rp.consensus_y == rf.consensus_y
    assert all(np.isfinite(rp.upper_loss))
    p, f = leaves(tuple(sp)), leaves(tuple(sf))
    assert all(np.array_equal(p[k], f[k]) for k in p)


@pytest.mark.parametrize("algo", ["mdbo", "vrdbo", "gt_sgd"])
def test_fused_equals_per_step_bitwise_on_cpu(algo):
    assert_fused_equals_per_step(algo, "dense")


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_fused_equals_per_step_bitwise_with_every_family(family):
    """MDBO on the moe, vlm and audio families: the MoE dispatch and
    combine, the image fusion and the encoder under the per-node ``vmap``,
    the vlm and audio batches' extras in the fused chunk's buffers."""
    assert_fused_equals_per_step("mdbo", family)


def test_lm_batch_draws_the_reference_distribution():
    """The port's stream is its own (a torch.Generator), so its law is
    held to the reference's: the token histograms of 2 x 10⁵ draws each
    (4 000 rows, each with its own shift) lie within 0.02 in total
    variation (sampling noise ~0.01), and the
    marginal is heavy-tailed: the ranks that the race clips to the last
    one (P = e⁻¹ before the shift) fill the 7 tokens the row shift spreads
    them over."""
    V, rows, seq = 64, 4000, 50
    b = pdata.lm_batch(torch.Generator().manual_seed(0), V, rows, seq)
    tok, lab = b["tokens"], b["labels"]
    assert tok.shape == lab.shape == (rows, seq)
    assert tok.dtype == lab.dtype == torch.int64
    assert int(tok.min()) >= 0 and int(tok.max()) < V
    assert torch.equal(tok[:, 1:], lab[:, :-1])
    ref = np.asarray(rdata.lm_batch(jax.random.PRNGKey(0), V, rows,
                                    seq)["tokens"])
    hp = np.bincount(tok.numpy().ravel(), minlength=V) / tok.numel()
    hr = np.bincount(ref.ravel(), minlength=V) / ref.size
    assert 0.5 * np.abs(hp - hr).sum() < 0.02
    clipped = hp[[V - 1, 0, 1, 2, 3, 4, 5]].sum()
    assert abs(clipped - hr[[V - 1, 0, 1, 2, 3, 4, 5]].sum()) < 0.01
    assert clipped > 0.35 and hp.max() < 0.1
    # the generator's seed fixes the draw
    b2 = pdata.lm_batch(torch.Generator().manual_seed(0), V, rows, seq)
    assert torch.equal(b2["tokens"], tok)


def test_lm_step_batch_structure():
    _, tcfg = configs("dense")
    gen = torch.Generator().manual_seed(0)
    b = pdata.make_lm_step_batch(tcfg, gen, 3, B, S, J=J)
    assert set(b) == {"f", "g", "h"}
    for part, lead in (("f", (3,)), ("g", (3,)), ("h", (3, J))):
        assert set(b[part]) == {"tokens", "labels"}
        assert tuple(b[part]["tokens"].shape) == lead + (B, S)
        assert torch.equal(b[part]["tokens"][..., 1:],
                           b[part]["labels"][..., :-1])
    # independent draws: no two parts, nodes or Neumann terms repeat
    assert not torch.equal(b["f"]["tokens"], b["g"]["tokens"])
    assert not torch.equal(b["h"]["tokens"][:, 0], b["h"]["tokens"][:, 1])
    tc = ptrain.TrainerConfig(J=J)
    again = ptrain.make_step_batch(tcfg, tc, torch.Generator().manual_seed(0),
                                   3, B, S)
    assert all(torch.equal(again[p][k], b[p][k]) for p in b for k in b[p])
    node = pdata.make_node_batch(tcfg, gen, B, S)
    assert tuple(node["tokens"].shape) == (B, S)


def test_lm_batch_extras_draw_the_reference_distribution():
    """The vlm and audio extras: shapes, dtypes, the image positions
    ``arange(n)`` in every row with ``n = min(n_img_tokens, seq)``, and
    embeddings of mean 0 and standard deviation 0.02 (the JAX stubs' law)
    over 1.3-5.1 x 10⁵ draws; none for the other families; the generator's
    seed fixes the draw."""
    rows = 1000
    _, vlm = configs("vlm")
    for seq, n in ((8, 4), (3, 3)):
        ex = pdata.lm_batch_extras(vlm, torch.Generator().manual_seed(0),
                                   rows, seq)
        assert set(ex) == {"image_embeds", "image_pos"}
        assert tuple(ex["image_embeds"].shape) == (rows, n, vlm.d_model)
        assert ex["image_embeds"].dtype == vlm.dtype
        assert ex["image_pos"].dtype == torch.int32
        assert torch.equal(ex["image_pos"],
                           torch.arange(n, dtype=torch.int32).expand(rows, n))
    _, audio = configs("audio")
    ex = pdata.lm_batch_extras(audio, torch.Generator().manual_seed(0), rows,
                               S)
    assert set(ex) == {"src_embeds"}
    assert tuple(ex["src_embeds"].shape) == (rows, audio.src_len,
                                             audio.d_model)
    for emb in (ex["src_embeds"], pdata.lm_batch_extras(
            vlm, torch.Generator().manual_seed(1), rows, S)["image_embeds"]):
        e = emb.double()
        assert abs(float(e.mean())) < 5 * 0.02 / e.numel() ** 0.5
        assert abs(float(e.std()) / 0.02 - 1) < 0.01
    again = pdata.lm_batch_extras(audio, torch.Generator().manual_seed(0),
                                  rows, S)
    assert torch.equal(again["src_embeds"], ex["src_embeds"])
    for family in ("dense", "moe"):
        assert pdata.lm_batch_extras(configs(family)[1], torch.Generator(),
                                     rows, S) == {}
    # the JAX stubs draw the same law
    ref = np.asarray(rdata.lm_batch_extras(configs("audio")[0],
                                           jax.random.PRNGKey(0), rows,
                                           S)["src_embeds"], np.float64)
    assert ref.shape == tuple(ex["src_embeds"].shape)
    assert abs(ref.std() / 0.02 - 1) < 0.01


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_lm_step_batch_structure_with_extras(family):
    """Every leaf keeps its own trailing shape under the node and J axes:
    the tokens ``[..., per_node, seq]``, the extras ``[..., per_node, *their
    own]``; each node and Neumann term draws its own extras."""
    _, tcfg = configs(family)
    b = pdata.make_lm_step_batch(tcfg, torch.Generator().manual_seed(0), 3,
                                 B, S, J=J)
    node = pdata.make_node_batch(tcfg, torch.Generator().manual_seed(0), B,
                                 S)
    assert set(node) > {"tokens", "labels"}
    for part, lead in (("f", (3,)), ("g", (3,)), ("h", (3, J))):
        assert set(b[part]) == set(node)
        for k, leaf in b[part].items():
            assert tuple(leaf.shape) == lead + tuple(node[k].shape), k
            assert leaf.dtype == node[k].dtype, k
    name = "image_embeds" if family == "vlm" else "src_embeds"
    assert not torch.equal(b["f"][name][0], b["f"][name][1])
    assert not torch.equal(b["h"][name][:, 0], b["h"][name][:, 1])
    if family == "vlm":
        assert torch.equal(b["h"]["image_pos"][1, 1], node["image_pos"])


def test_make_step_fns_match_the_engine():
    _, tcfg = configs("dense")
    tc = ptrain.TrainerConfig(J=J, mix="ring", hp=HParams(**HP))
    problem, init, step = ptrain.make_step_fns(tcfg, tc)
    eng = port_engine("mdbo", "dense")
    mix = ptrain.make_mix(tc, K, device="cpu")
    gen = torch.Generator().manual_seed(0)
    X0 = pengine.replicate(problem.init_x(gen, "cpu"), K)
    Y0 = pengine.replicate(problem.init_y(gen, "cpu"), K)
    b = ptrain.make_step_batch(tcfg, tc, gen, K, B, S)
    jt = torch.tensor([0, 1])
    s0, e0 = init(mix, X0, Y0, b, jt), eng.init(X0, Y0, b, jt)
    s1, e1 = step(mix, s0, b, jt), eng.step(e0, b, jt)
    p, q = leaves(tuple(s1)), leaves(tuple(e1))
    assert all(np.array_equal(p[k], q[k]) for k in p)
    assert ptrain.x_dim(tcfg) == tcfg.n_layers + 1
    assert ptrain.make_mix(tc, 1, device="cpu")("same") == "same"
    with pytest.raises(ValueError):
        ptrain.make_step_fns(tcfg, ptrain.TrainerConfig(algo="sgd"))


def checkpoint_tree():
    """A reference tree shaped like a hybrid state — stacked ``blocks`` and
    a ``rem`` list — with a bf16 leaf and an int leaf, and its port copy."""
    rng = np.random.default_rng(2)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    y = {"blocks": {"l0_rec": {"rec": {"lam": f32(2, 4, 8)}}},
         "rem": [{"rec": {"lam": f32(4, 8)}, "norm1": {"scale": f32(4, 3)}}],
         "embed": {"table": f32(4, 5, 3)},
         "final_norm": {"scale": f32(4, 3)}}
    jt = {"x": jnp.arange(3, dtype=jnp.float32),
          "y": jax.tree.map(jnp.asarray, y),
          "h": jnp.linspace(0, 1, 5).astype(jnp.bfloat16),
          "n": jnp.arange(4, dtype=jnp.int32)}
    pt = {"x": torch.arange(3, dtype=torch.float32),
          "y": params_from_jax(y, device="cpu"),
          "h": torch.from_numpy(np.asarray(jt["h"], np.float32)).to(
              torch.bfloat16),
          "n": torch.arange(4, dtype=torch.int32)}
    return jt, pt


def test_checkpoints_cross_restore_both_ways(tmp_path):
    jt, pt = checkpoint_tree()
    assert pckpt.latest_step(str(tmp_path / "none")) is None
    # the port writes, the reference restores
    pckpt.save(str(tmp_path / "p"), 7, pt, extra={"arch": "tiny"})
    pckpt.save(str(tmp_path / "p"), 3, pt)
    assert rckpt.latest_step(str(tmp_path / "p")) == 7
    back = rckpt.restore(str(tmp_path / "p"), 7, jt)
    for k, v in jleaves(jt).items():
        w = jleaves(back)[k]
        assert w.dtype == v.dtype and np.array_equal(w, v), k
    # the reference writes, the port restores
    rckpt.save(str(tmp_path / "r"), 9, jt)
    assert pckpt.latest_step(str(tmp_path / "r")) == 9
    assert (pckpt.load_pytree(str(tmp_path / "r"), 9).keys()
            == rckpt.load_pytree(str(tmp_path / "p"), 7).keys())
    got = pckpt.restore(str(tmp_path / "r"), 9, pt)
    assert got["h"].dtype == torch.bfloat16 and isinstance(got["y"]["rem"],
                                                           list)
    want = leaves(pt)
    for k, v in leaves(got).items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    # same file names and manifest in both packages
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == ["ckpt_00000003.json", "ckpt_00000003.npz",
                     "ckpt_00000007.json", "ckpt_00000007.npz"]
    manifest = (tmp_path / "p" / "ckpt_00000007.json").read_text()
    assert "\"['y']::['rem']::[0]::['rec']::['lam']\"" in manifest
    assert "\"extra\": {\"arch\": \"tiny\"}" in manifest
    bad = {**pt, "x": torch.zeros(4)}
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore(str(tmp_path / "r"), 9, bad)


@pytest.mark.parametrize("family", ["moe", "audio"])
def test_model_checkpoints_cross_restore(tmp_path, family):
    """A node-stacked MoE tree (``router``, ``wi``, ``wg``, ``wo``) and an
    audio tree (``enc_layers``, ``enc_norm``, ``cross``, ``norm3``) written
    by either package restore in the other, leaf for leaf."""
    jcfg, tcfg = configs(family)
    y = jax.tree.map(lambda a: np.stack([np.asarray(a), -np.asarray(a)]),
                     repro.models.init_params(jcfg, jax.random.PRNGKey(1)))
    jt = {"x": jnp.arange(2 * rtrain.x_dim(jcfg), dtype=jnp.float32
                          ).reshape(2, -1),
          "y": jax.tree.map(jnp.asarray, y)}
    pt = {"x": torch.from_numpy(np.asarray(jt["x"])),
          "y": params_from_jax(y, device="cpu")}
    names = {"moe": ("router", "wi", "wg", "wo"),
             "audio": ("enc_layers", "enc_norm", "cross", "norm3")}[family]
    assert all(any(f"['{n}']" in k for k in leaves(pt)) for n in names)
    pckpt.save(str(tmp_path / "p"), 5, pt)
    back = jleaves(rckpt.restore(str(tmp_path / "p"), 5, jt))
    assert back.keys() == jleaves(jt).keys()
    for k, v in jleaves(jt).items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    rckpt.save(str(tmp_path / "r"), 6, jt)
    template = {"x": torch.zeros(2, ptrain.x_dim(tcfg)),
                "y": pengine.replicate(init_params(
                    tcfg, torch.Generator().manual_seed(0), device="cpu"), 2)}
    got, want = leaves(pckpt.restore(str(tmp_path / "r"), 6, template)), \
        leaves(pt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_cli_trains_and_writes_checkpoints(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` in-process on the CPU: its
    lines, its checkpoints at the eval boundaries, and a restore that gives
    back the state it saved."""
    kept = {}
    res, eng = ptrain_cli.main(
        ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
         "--nodes", "2", "--batch", "1", "--seq", "8", "--steps", "3",
         "--eval-every", "2", "--ckpt-dir", str(tmp_path)],
        on_eval=lambda t, s: kept.setdefault(t, leaves(
            {"x": s.x, "y": s.y})))
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=smollm-360m algo=mdbo K=2 "
                             "dispatch=fused params/node=1,443,072")
    assert [line.split()[1] for line in out[1:4]] == ["0", "2", "3"]
    assert out[4].startswith("wall=") and "steps/s" in out[4]
    assert out[5] == f"checkpoints in {tmp_path}"
    assert res.steps == [0, 2, 3] and eng.K == 2
    assert all(np.isfinite(res.upper_loss))
    assert pckpt.latest_step(str(tmp_path)) == 3
    assert sorted(p.name for p in tmp_path.iterdir())[0] == \
        "ckpt_00000002.json"
    cfg = repro_torch.configs.get("smollm-360m").reduced()
    template = {"x": torch.zeros(2, ptrain.x_dim(cfg)),
                "y": pengine.replicate(init_params(
                    cfg, torch.Generator().manual_seed(0), device="cpu"), 2)}
    for t in (2, 3):
        got = leaves(pckpt.restore(str(tmp_path), t, template))
        assert all(np.array_equal(got[k], kept[t][k]) for k in got)


def test_not_ported_paths_raise():
    _, tcfg = configs("dense")
    tc = ptrain.TrainerConfig(J=J)
    with pytest.raises(NotImplementedError, match="item 6"):
        ptrain.make_trainer_engine(tcfg, tc, K, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        ptrain.make_trainer_engine(tcfg, tc, K, mix="ring_local",
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        ptrain.make_mix(ptrain.TrainerConfig(mix="ring_local"), K,
                        device="cpu")
    # the placement and dry-run helpers are ported since slice 11 (held to
    # the JAX package in tests/test_torch_dryrun.py); they build shapes
    # only, on the meta device
    for out in (ptrain.step_batch_specs(tcfg, tc, K, B, S),
                ptrain.node_keys_spec(K), ptrain.state_shape(tcfg, tc, K)):
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(out))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Repair of the mix builders' CPU default: ``make_mix`` and
    ``dense_mix`` resolve their device as every entry point does."""
    _, tcfg = configs("dense")
    tc = ptrain.TrainerConfig(J=J)
    W = ring(4).weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pengine.make_mix("dense", K=4),
                 lambda: pengine.make_mix("ring_rolled", K=4),
                 lambda: ptrack.dense_mix(W),
                 lambda: ptrain.make_mix(tc, 4),
                 lambda: ptrain.make_trainer_engine(tcfg, tc, K),
                 lambda: ptrain_cli.main(["--arch", "smollm-360m",
                                          "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.allclose(pengine.make_mix("dense", K=4, device="cpu")(x),
                          pengine.make_mix("ring_rolled", K=4,
                                           device="cpu")(x))
    assert ptrack.dense_mix(W, "cpu")(x).device.type == "cpu"


def test_new_modules_pass_the_reference_ast_lint():
    """The trainer's modules and the model modules it changed lint clean
    under the JAX package's own AST rules, with no suppression."""
    from repro.analysis.ast_rules import lint_source

    port = ROOT / "src" / "repro_torch"
    files = (sorted((port / "train").glob("*.py"))
             + sorted((port / "checkpoint").glob("*.py"))
             + [port / "launch" / "train.py", port / "data" / "lm.py",
                port / "data" / "synthetic.py",
                port / "models" / "transformer.py", port / "models" / "moe.py",
                port / "models" / "rglru.py", port / "models" / "rwkv6.py"])
    assert len(files) == 12
    for f in files:
        text = f.read_text()
        assert "noqa" not in text
        assert lint_source(text, str(f.relative_to(ROOT))) == []
